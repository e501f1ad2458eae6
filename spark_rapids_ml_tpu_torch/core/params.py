"""Spark ML Params/Estimator/Model contract (host-only; a copy of the JAX
package's ``core/params.py`` so the PyTorch port imports nothing of it).

The reference plugs into Spark's own machinery (``RapidsPCAParams`` extends
``PCAParams``, reference RapidsPCA.scala:34-46; ``copy(extra)`` at :86,177-180;
``DefaultParamsWritable/Readable`` at :53,90). Since this framework is
Python-first (no JVM in the loop), we reproduce the *contract* — typed
params with defaults, user-set vs default maps, fluent setters, ``copy(extra)``,
``explainParams`` and JSON persistence — so estimators behave like Spark ML
estimators and a PySpark shim can later delegate 1:1.

Design notes (intentionally NOT a port): params are declared as class
attributes and bound per-instance at construction, matching Spark's
parent-uid binding so ``copy()``/persistence round-trips preserve uids.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

T = TypeVar("T")

_uid_lock = threading.Lock()
_uid_counters: Dict[str, int] = {}


def _random_uid(prefix: str) -> str:
    # Spark uses {prefix}_{12-hex}; keep a short monotonic suffix for readable
    # test output plus entropy for uniqueness across processes.
    with _uid_lock:
        _uid_counters[prefix] = _uid_counters.get(prefix, 0) + 1
        n = _uid_counters[prefix]
    return f"{prefix}_{uuid.uuid4().hex[:8]}{n:04x}"


class TypeConverters:
    """Value converters mirroring pyspark.ml.param.TypeConverters."""

    @staticmethod
    def toInt(value: Any) -> int:
        if isinstance(value, bool):
            raise TypeError(f"cannot convert bool {value!r} to int param")
        iv = int(value)
        if iv != value:
            raise TypeError(f"cannot losslessly convert {value!r} to int")
        return iv

    @staticmethod
    def toFloat(value: Any) -> float:
        if isinstance(value, bool):
            raise TypeError(f"cannot convert bool {value!r} to float param")
        return float(value)

    @staticmethod
    def toBoolean(value: Any) -> bool:
        if not isinstance(value, bool):
            raise TypeError(f"expected bool, got {type(value).__name__}")
        return value

    @staticmethod
    def toString(value: Any) -> str:
        if not isinstance(value, str):
            raise TypeError(f"expected str, got {type(value).__name__}")
        return value

    @staticmethod
    def toListFloat(value: Any) -> List[float]:
        return [TypeConverters.toFloat(v) for v in value]

    @staticmethod
    def identity(value: Any) -> Any:
        return value


class _Cmp:
    """Picklable predicate (lambdas would break shipping params/models to
    Spark executors through stdlib pickle)."""

    __slots__ = ("op", "a", "b")

    def __init__(self, op, a, b=None):
        self.op, self.a, self.b = op, a, b

    def __call__(self, v):
        if self.op == "gt":
            return v > self.a
        if self.op == "gtEq":
            return v >= self.a
        if self.op == "lt":
            return v < self.a
        if self.op == "ltEq":
            return v <= self.a
        if self.op == "inRange":
            return self.a <= v <= self.b
        return v in self.a  # inList

    def __getstate__(self):
        return (self.op, self.a, self.b)

    def __setstate__(self, state):
        self.op, self.a, self.b = state


class ParamValidators:
    """Value-validity predicates, mirroring org.apache.spark.ml.param.ParamValidators
    (the reference's inherited ``k`` uses ``gt(0)`` via Spark's PCAParams)."""

    @staticmethod
    def gt(lower):
        return _Cmp("gt", lower)

    @staticmethod
    def gtEq(lower):
        return _Cmp("gtEq", lower)

    @staticmethod
    def lt(upper):
        return _Cmp("lt", upper)

    @staticmethod
    def ltEq(upper):
        return _Cmp("ltEq", upper)

    @staticmethod
    def inRange(lower, upper):
        return _Cmp("inRange", lower, upper)

    @staticmethod
    def inList(allowed):
        return _Cmp("inList", tuple(allowed))


class Param(Generic[T]):
    """A named, documented, typed parameter owned by a :class:`Params` instance.

    Mirrors ``org.apache.spark.ml.param.Param`` (used by the reference's
    ``meanCentering`` BooleanParam, RapidsPCA.scala:40-41).
    """

    __slots__ = ("parent", "name", "doc", "typeConverter", "validator")

    def __init__(
        self,
        parent: "Params",
        name: str,
        doc: str,
        typeConverter: Callable[[Any], T] = TypeConverters.identity,
        validator: Optional[Callable[[T], bool]] = None,
    ):
        self.parent = parent.uid if isinstance(parent, Params) else str(parent)
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter
        self.validator = validator

    def _convert(self, value: T) -> T:
        """Convert + validate, raising the Spark-style error on rejection."""
        converted = self.typeConverter(value)
        if self.validator is not None and not self.validator(converted):
            raise ValueError(
                f"{self.parent} parameter {self.name} given invalid value "
                f"{converted!r}."
            )
        return converted

    def __repr__(self) -> str:
        return f"{self.parent}__{self.name}"

    def __hash__(self) -> int:
        return hash(repr(self))

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Param) and repr(self) == repr(other)


class _ParamDecl:
    """Class-level declaration of a param; bound to an instance Param at init.

    Usage in an estimator class body::

        k = _ParamDecl("k", "number of principal components", TypeConverters.toInt)
    """

    __slots__ = ("name", "doc", "typeConverter", "validator")

    def __init__(self, name, doc, typeConverter=TypeConverters.identity, validator=None):
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter
        self.validator = validator


# Public alias used by model classes when declaring params.
ParamDecl = _ParamDecl


class Params:
    """Base class carrying a uid, param registry, user-set and default maps.

    Subclasses declare params with :class:`ParamDecl` class attributes; the
    constructor binds them to per-instance :class:`Param` objects (so the
    param's ``parent`` is this instance's uid, as in Spark).
    """

    # Prefix for generated uids; subclasses override.
    _uid_prefix = "params"

    def __init__(self, uid: Optional[str] = None):
        self.uid = uid or _random_uid(self._uid_prefix)
        self._params: Dict[str, Param] = {}
        self._paramMap: Dict[Param, Any] = {}
        self._defaultParamMap: Dict[Param, Any] = {}
        # Bind declared params (walk the MRO so mixins contribute).
        seen = set()
        for klass in type(self).__mro__:
            for attr_name, decl in vars(klass).items():
                if isinstance(decl, _ParamDecl) and decl.name not in seen:
                    seen.add(decl.name)
                    p = Param(
                        self, decl.name, decl.doc, decl.typeConverter, decl.validator
                    )
                    setattr(self, attr_name, p)
                    self._params[decl.name] = p

    # Attribute names reset when pickling (estimators/models ship to Spark
    # executors inside transform/feed tasks): jitted-closure caches, device
    # arrays, and mesh handles are process-local and rebuild lazily on the
    # other side. Names ending in ``_cache`` reset to {} automatically;
    # subclasses extend this tuple for other device-resident state.
    _transient_attrs: tuple = ("_mesh",)

    def __getstate__(self):
        state = dict(self.__dict__)
        for name in list(state):
            if name.endswith("_cache"):
                state[name] = {} if isinstance(state[name], dict) else None
            elif name in self._transient_attrs:
                state[name] = None
        return state

    # -- registry ----------------------------------------------------------
    @property
    def params(self) -> List[Param]:
        return [self._params[name] for name in sorted(self._params)]

    def hasParam(self, paramName: str) -> bool:
        return paramName in self._params

    def getParam(self, paramName: str) -> Param:
        if not self.hasParam(paramName):
            raise AttributeError(f"{type(self).__name__} has no param {paramName!r}")
        return self._params[paramName]

    def _resolveParam(self, param) -> Param:
        if isinstance(param, Param):
            # Accept a param belonging to a same-shaped instance (Spark
            # requires identical parent; we re-resolve by name which is what
            # user code actually needs).
            return self.getParam(param.name)
        return self.getParam(param)

    # -- set/get -----------------------------------------------------------
    def set(self, param, value) -> "Params":  # noqa: A003
        p = self._resolveParam(param)
        self._paramMap[p] = p._convert(value)
        return self

    def _set(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            p = self.getParam(name)
            self._paramMap[p] = p._convert(value)
        return self

    def setDefault(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            p = self.getParam(name)
            self._defaultParamMap[p] = p._convert(value)
        return self

    def isSet(self, param) -> bool:
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param) -> bool:
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param) -> bool:
        return self.isSet(param) or self.hasDefault(param)

    def get(self, param) -> Any:  # noqa: A003
        return self.getOrDefault(param)

    def getOrDefault(self, param) -> Any:
        p = self._resolveParam(param)
        if p in self._paramMap:
            return self._paramMap[p]
        if p in self._defaultParamMap:
            return self._defaultParamMap[p]
        raise KeyError(f"param {p.name!r} is neither set nor has a default")

    def clear(self, param) -> "Params":
        self._paramMap.pop(self._resolveParam(param), None)
        return self

    # -- copy / extract ----------------------------------------------------
    def copy(self, extra: Optional[Dict[Param, Any]] = None) -> "Params":
        """Shallow-copy with the same uid, applying ``extra`` overrides.

        Matches the ``copy(extra: ParamMap)`` contract the reference
        implements at RapidsPCA.scala:86 and :177-180.
        """
        that = type(self)(uid=self.uid) if self._accepts_uid() else type(self)()
        that.uid = self.uid
        for name, p in self._params.items():
            tp = that._params[name]
            if p in self._paramMap:
                that._paramMap[tp] = self._paramMap[p]
            if p in self._defaultParamMap:
                that._defaultParamMap[tp] = self._defaultParamMap[p]
        that._copy_extra_state(self)
        if extra:
            for param, value in extra.items():
                if isinstance(param, Param):
                    # pyspark semantics: ParamMaps key by (parent uid, name).
                    # A Param-keyed extra applies only to the instance whose
                    # uid it was bound to — a grid built on one Pipeline
                    # stage's params must pass through the Pipeline's own
                    # copy unharmed and must NOT hit same-named params on
                    # other stages (e.g. LinearRegression.maxIter vs
                    # KMeans.maxIter, or 'k' on PCA vs KMeans). Copies
                    # preserve uids, so parent-uid equality is the right key.
                    if that.hasParam(param.name) and param.parent == that.uid:
                        that.set(param, value)
                else:
                    # String keys keep the typo guard: unknown names raise.
                    that.set(param, value)
        return that

    @classmethod
    def _accepts_uid(cls) -> bool:
        import inspect

        try:
            return "uid" in inspect.signature(cls.__init__).parameters
        except (TypeError, ValueError):
            return False

    def _copy_extra_state(self, source: "Params") -> None:
        """Hook for models to copy non-param state (e.g. fitted matrices)."""

    def _copy_params_to(self, target: "Params") -> "Params":
        """Copy set and default params onto ``target`` (by name), skipping
        params the target doesn't declare. Used by Estimator._fit to flow
        parent params to the produced Model (Spark Model.copy semantics)."""
        for name, p in self._params.items():
            if not target.hasParam(name):
                continue
            if p in self._defaultParamMap:
                target.setDefault(**{name: self._defaultParamMap[p]})
            if p in self._paramMap:
                target._set(**{name: self._paramMap[p]})
        return target

    def extractParamMap(self, extra=None) -> Dict[Param, Any]:
        out = dict(self._defaultParamMap)
        out.update(self._paramMap)
        if extra:
            out.update(extra)
        return out

    def explainParam(self, param) -> str:
        p = self._resolveParam(param)
        if p in self._paramMap:
            state = f"current: {self._paramMap[p]!r}"
        elif p in self._defaultParamMap:
            state = f"default: {self._defaultParamMap[p]!r}"
        else:
            state = "undefined"
        return f"{p.name}: {p.doc} ({state})"

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params)


# ---------------------------------------------------------------------------
# Shared param mixins (pyspark.ml.param.shared equivalents) — the ones the
# PCA, KMeans, LinearRegression and LogisticRegression estimators use. The
# reference inherits inputCol/outputCol/k from Spark's PCAParams
# (RapidsPCA.scala:34).
# ---------------------------------------------------------------------------


class HasInputCol(Params):
    inputCol = ParamDecl("inputCol", "input column name", TypeConverters.toString)

    def getInputCol(self) -> str:
        return self.getOrDefault(self.inputCol)

    def setInputCol(self, value: str):
        return self._set(inputCol=value)


class HasOutputCol(Params):
    outputCol = ParamDecl("outputCol", "output column name", TypeConverters.toString)

    def getOutputCol(self) -> str:
        return self.getOrDefault(self.outputCol)

    def setOutputCol(self, value: str):
        return self._set(outputCol=value)


class HasFeaturesCol(Params):
    featuresCol = ParamDecl(
        "featuresCol", "features column name", TypeConverters.toString
    )

    def getFeaturesCol(self) -> str:
        return self.getOrDefault(self.featuresCol)

    def setFeaturesCol(self, value: str):
        return self._set(featuresCol=value)


class HasLabelCol(Params):
    labelCol = ParamDecl("labelCol", "label column name", TypeConverters.toString)

    def getLabelCol(self) -> str:
        return self.getOrDefault(self.labelCol)

    def setLabelCol(self, value: str):
        return self._set(labelCol=value)


class HasPredictionCol(Params):
    predictionCol = ParamDecl(
        "predictionCol", "prediction column name", TypeConverters.toString
    )

    def getPredictionCol(self) -> str:
        return self.getOrDefault(self.predictionCol)

    def setPredictionCol(self, value: str):
        return self._set(predictionCol=value)


class HasProbabilityCol(Params):
    probabilityCol = ParamDecl(
        "probabilityCol",
        "column of predicted class conditional probabilities",
        TypeConverters.toString,
    )

    def getProbabilityCol(self) -> str:
        return self.getOrDefault(self.probabilityCol)

    def setProbabilityCol(self, value: str):
        return self._set(probabilityCol=value)


class HasRawPredictionCol(Params):
    rawPredictionCol = ParamDecl(
        "rawPredictionCol",
        "raw prediction (confidence / margin) column name",
        TypeConverters.toString,
    )

    def getRawPredictionCol(self) -> str:
        return self.getOrDefault(self.rawPredictionCol)

    def setRawPredictionCol(self, value: str):
        return self._set(rawPredictionCol=value)


class HasSeed(Params):
    seed = ParamDecl("seed", "random seed", TypeConverters.toInt)

    def getSeed(self) -> int:
        return self.getOrDefault(self.seed)

    def setSeed(self, value: int):
        return self._set(seed=value)


class HasMaxIter(Params):
    maxIter = ParamDecl(
        "maxIter",
        "maximum number of iterations (>= 0)",
        TypeConverters.toInt,
        validator=ParamValidators.gtEq(0),
    )

    def getMaxIter(self) -> int:
        return self.getOrDefault(self.maxIter)

    def setMaxIter(self, value: int):
        return self._set(maxIter=value)


class HasTol(Params):
    tol = ParamDecl(
        "tol",
        "convergence tolerance (>= 0)",
        TypeConverters.toFloat,
        validator=ParamValidators.gtEq(0),
    )

    def getTol(self) -> float:
        return self.getOrDefault(self.tol)

    def setTol(self, value: float):
        return self._set(tol=value)


class HasRegParam(Params):
    regParam = ParamDecl(
        "regParam",
        "regularization parameter (>= 0)",
        TypeConverters.toFloat,
        validator=ParamValidators.gtEq(0),
    )

    def getRegParam(self) -> float:
        return self.getOrDefault(self.regParam)

    def setRegParam(self, value: float):
        return self._set(regParam=value)


class HasElasticNetParam(Params):
    elasticNetParam = ParamDecl(
        "elasticNetParam",
        "ElasticNet mixing: 0 = L2 penalty, 1 = L1 penalty",
        TypeConverters.toFloat,
        validator=ParamValidators.inRange(0.0, 1.0),
    )

    def getElasticNetParam(self) -> float:
        return self.getOrDefault(self.elasticNetParam)

    def setElasticNetParam(self, value: float):
        return self._set(elasticNetParam=value)


class HasFitIntercept(Params):
    fitIntercept = ParamDecl(
        "fitIntercept", "whether to fit an intercept term", TypeConverters.toBoolean
    )

    def getFitIntercept(self) -> bool:
        return self.getOrDefault(self.fitIntercept)

    def setFitIntercept(self, value: bool):
        return self._set(fitIntercept=value)


# ---------------------------------------------------------------------------
# Estimator / Model
# ---------------------------------------------------------------------------


class Estimator(Params):
    """fit(dataset) -> Model. Mirrors org.apache.spark.ml.Estimator."""

    def fit(self, dataset, params: Optional[Dict[Param, Any]] = None):
        if params:
            return self.copy(params).fit(dataset)
        return self._fit(dataset)

    def _fit(self, dataset):
        raise NotImplementedError


class Model(Params):
    """Transformer produced by an Estimator. Mirrors org.apache.spark.ml.Model."""

    def transform(self, dataset, params: Optional[Dict[Param, Any]] = None):
        if params:
            return self.copy(params).transform(dataset)
        return self._transform(dataset)

    def _transform(self, dataset):
        raise NotImplementedError
