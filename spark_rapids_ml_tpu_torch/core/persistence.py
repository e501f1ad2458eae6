"""Model/estimator persistence: params JSON + data Parquet.

The port's copy of ``spark_rapids_ml_tpu/core/persistence.py``. It keeps
the Spark ML on-disk contract the reference uses (RapidsPCA.scala:193-228 —
``DefaultParamsWriter.saveMetadata`` + a single-partition data dir)::

    path/
      metadata/part-00000     <- one JSON object (class, uid, params, defaults)
      data/part-00000.parquet <- model payload (fitted arrays), when a Model
                                 (part-00000.npz when pyarrow is missing)

The metadata's ``class`` is the layout's name for the model, shared with
the JAX package: every persisted class of the port sets ``_persist_class``
to the JAX package's name for it, and defining the class enters that name
in a table (:func:`persisted_class`). A load resolves the saved name there
first, so a directory saved by either package loads here into the port's
classes, the untyped loads of Pipeline stages and tuned best models
included; a name of the JAX package that the table lacks raises, and is
never imported. So a model saved by one package loads in the other.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np

#: The JAX package's module prefix: a saved name under it resolves through
#: the table below, never by importing it.
_REFERENCE_PREFIX = "spark_rapids_ml_tpu."

#: Persisted class name → the port's class that loads it, filled as each
#: persisted class is defined (``MLReadable.__init_subclass__``).
_PERSISTED: Dict[str, type] = {}


def persisted_class(name: str):
    """The port's class for a saved ``class`` name: the table's entry; else,
    for a name outside the JAX package, the named class imported."""
    cls = _PERSISTED.get(name)
    if cls is not None:
        return cls
    if name.startswith(_REFERENCE_PREFIX):
        raise ValueError(
            f"saved class {name} belongs to the JAX package and the port has no "
            f"counterpart for it (known: {sorted(_PERSISTED)})"
        )
    module_name, _, cls_name = name.rpartition(".")
    return getattr(importlib.import_module(module_name), cls_name)


def _parquet():
    """(pyarrow, pyarrow.parquet), or (None, None) where pyarrow is absent
    (the GPU image ships without it): imported at use, so importing the
    package never loads pyarrow."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:  # pragma: no cover - the GPU image
        return None, None
    return pa, pq


def _json_default(value: Any):
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, np.ndarray):
        return value.tolist()
    raise TypeError(f"not JSON-serializable: {type(value)}")


class MLWriter:
    """write() handle: ``model.write().overwrite().save(path)``."""

    def __init__(self, instance):
        self._instance = instance
        self._overwrite = False

    def overwrite(self) -> "MLWriter":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        if os.path.exists(path):
            if not self._overwrite:
                raise FileExistsError(
                    f"path {path} already exists; use write().overwrite().save()"
                )
            shutil.rmtree(path)
        os.makedirs(path)
        DefaultParamsWriter.save_metadata(self._instance, path)
        payload = getattr(self._instance, "_model_data", None)
        if callable(payload):
            data = payload()
            if data:
                _write_data(path, data)


class MLReader:
    def __init__(self, cls):
        self._cls = cls

    def load(self, path: str):
        return DefaultParamsReader.load_instance(path, expected_cls=self._cls)


def _write_data(path: str, data: Dict[str, np.ndarray]) -> None:
    data_dir = os.path.join(path, "data")
    os.makedirs(data_dir, exist_ok=True)
    pa, pq = _parquet()
    if pa is not None:
        # One single-row table: each fitted tensor is one flat list cell,
        # its shape kept in the __shapes__ JSON column.
        cols: Dict[str, Any] = {}
        shapes: Dict[str, Any] = {}
        for name, arr in data.items():
            arr = np.asarray(arr)
            shapes[name] = list(arr.shape)
            cols[name] = [arr.reshape(-1).tolist()]
        cols["__shapes__"] = [json.dumps(shapes)]
        pq.write_table(pa.table(cols), os.path.join(data_dir, "part-00000.parquet"))
    else:  # pragma: no cover - numpy fallback
        np.savez(os.path.join(data_dir, "part-00000.npz"), **data)


def _read_data(path: str) -> Optional[Dict[str, np.ndarray]]:
    data_dir = os.path.join(path, "data")
    if not os.path.isdir(data_dir):
        return None
    pq_path = os.path.join(data_dir, "part-00000.parquet")
    if os.path.exists(pq_path):
        pa, pq = _parquet()
        if pa is None:
            raise ImportError(f"{pq_path} needs pyarrow to read")
        table = pq.read_table(pq_path)
        shapes = json.loads(table.column("__shapes__")[0].as_py())
        return {
            name: np.asarray(table.column(name)[0].as_py(), dtype=np.float64).reshape(shape)
            for name, shape in shapes.items()
        }
    npz_path = os.path.join(data_dir, "part-00000.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path) as z:
            return {k: z[k] for k in z.files}
    return None


def _class_name(cls) -> str:
    return getattr(cls, "_persist_class", None) or f"{cls.__module__}.{cls.__qualname__}"


class DefaultParamsWriter:
    @staticmethod
    def save_metadata(instance, path: str, extra: Optional[Dict[str, Any]] = None) -> None:
        meta = {
            "class": _class_name(type(instance)),
            "timestamp": int(time.time() * 1000),
            "sparkVersion": "torch-native",
            "uid": instance.uid,
            "paramMap": {p.name: v for p, v in instance._paramMap.items()},
            "defaultParamMap": {p.name: v for p, v in instance._defaultParamMap.items()},
        }
        if extra:
            meta.update(extra)
        meta_dir = os.path.join(path, "metadata")
        os.makedirs(meta_dir, exist_ok=True)
        with open(os.path.join(meta_dir, "part-00000"), "w") as f:
            json.dump(meta, f, default=_json_default)
        # Spark writes an empty _SUCCESS marker per saved dir.
        open(os.path.join(meta_dir, "_SUCCESS"), "w").close()


class DefaultParamsReader:
    @staticmethod
    def load_metadata(path: str) -> Dict[str, Any]:
        with open(os.path.join(path, "metadata", "part-00000")) as f:
            return json.load(f)

    @staticmethod
    def load_instance(path: str, expected_cls=None):
        meta = DefaultParamsReader.load_metadata(path)
        saved = meta["class"]
        if expected_cls is not None and saved.rpartition(".")[2] == expected_cls.__name__:
            cls = expected_cls
        else:
            cls = persisted_class(saved)
            if expected_cls is not None and not issubclass(cls, expected_cls):
                raise TypeError(f"saved class {saved} is not a {expected_cls.__name__}")
        data = _read_data(path)
        if data is not None and hasattr(cls, "_from_model_data"):
            instance = cls._from_model_data(meta["uid"], data)
        else:
            instance = cls(uid=meta["uid"]) if cls._accepts_uid() else cls()
            instance.uid = meta["uid"]
        for name, value in meta.get("defaultParamMap", {}).items():
            if instance.hasParam(name):
                instance.setDefault(**{name: value})
        for name, value in meta.get("paramMap", {}).items():
            if instance.hasParam(name):
                instance._set(**{name: value})
        return instance


class MLWritable:
    """Mixin: DefaultParamsWritable equivalent (RapidsPCA.scala:53,182)."""

    def write(self) -> MLWriter:
        return MLWriter(self)

    def save(self, path: str) -> None:
        self.write().save(path)


class MLReadable:
    """Mixin: DefaultParamsReadable equivalent (RapidsPCA.scala:90,205).

    A subclass that declares ``_persist_class`` in its own body is entered
    in the table of persisted names under it."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        name = cls.__dict__.get("_persist_class")
        if name:
            _PERSISTED[name] = cls

    @classmethod
    def read(cls) -> MLReader:
        return MLReader(cls)

    @classmethod
    def load(cls, path: str):
        return cls.read().load(path)
