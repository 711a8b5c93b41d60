"""``plain(x)``: a value of either package as builtins, so one of the JAX
package's results and the port's counterpart compare with ``==`` and no
tolerance: dataclasses and named tuples by class name and fields, enums by
class name and value, numpy arrays by dtype, shape and bytes, tuples as
lists.  No JAX and no torch here."""

import dataclasses
import enum

import numpy as np


def plain(x):
    if isinstance(x, enum.Enum):
        return ["enum", type(x).__name__, plain(x.value)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ["dataclass", type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)}]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return ["namedtuple", type(x).__name__,
                {k: plain(getattr(x, k)) for k in x._fields}]
    if isinstance(x, np.ndarray):
        return ["ndarray", x.dtype.str, list(x.shape), x.tobytes()]
    if isinstance(x, np.generic):
        return ["scalar", x.dtype.str, x.tobytes()]
    if isinstance(x, dict):
        return ["dict", [[plain(k), plain(v)] for k, v in x.items()]]
    if isinstance(x, (list, tuple)):
        return [type(x).__name__] + [plain(v) for v in x]
    if isinstance(x, float):
        return ["float", repr(x)]
    return x
