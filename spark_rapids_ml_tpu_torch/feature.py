"""Drop-in feature-transformer namespace.

The port of ``spark_rapids_ml_tpu/feature.py``. The reference's public entry
point is ``com.nvidia.spark.ml.feature.PCA`` (reference PCA.scala:27-37), a
thin alias namespace so user code changes only the import::

    from spark_rapids_ml_tpu_torch.feature import PCA
"""

from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel
from spark_rapids_ml_tpu_torch.models.scaler import StandardScaler, StandardScalerModel

__all__ = ["PCA", "PCAModel", "StandardScaler", "StandardScalerModel"]
