"""Shared helpers of the parity tests between the JAX package (``repro``) and
its PyTorch port (``repro_torch``): carrying a reference database across as
numpy, comparing outputs, and switching the reference's Pallas dispatch.

Not a test module itself (no ``test_`` prefix); the ``test_torch_*`` files
import it.
"""

import contextlib
import math

import numpy as np

from repro.kernels import ops as ref_ops
from repro_torch.carry import database_from_numpy

# fp32 reductions run in another order in XLA and in torch: a non-integral
# fp32 aggregate may differ in its last bits, never more than this
FP32_RTOL = 1e-5


def export_tables(db):
    """The reference server's tables as numpy, in the shape
    :func:`repro_torch.carry.database_from_numpy` takes."""
    out = {}
    for name, t in db.tables.items():
        fields = [(f.name, f.dtype, f.wire_bytes) for f in t.schema.fields]
        cols = {f.name: np.asarray(t.column(f.name)) for f in t.schema.fields}
        out[name] = (fields, cols)
    return out


def carry(db, stats_config=None):
    """The port's server on the CPU, holding the reference server's rows."""
    return database_from_numpy(export_tables(db), device="cpu",
                               stats_config=stats_config)


def assert_values_match(a, b, path="value"):
    """Integers and integral floats exactly; other floats within
    :data:`FP32_RTOL`; containers element by element."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_values_match(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_values_match(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not (math.isfinite(a) and a.is_integer()):
        assert isinstance(b, (int, float)), path
        assert math.isclose(a, b, rel_tol=FP32_RTOL, abs_tol=0.0), \
            f"{path}: {a!r} != {b!r}"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"
        assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, path


@contextlib.contextmanager
def reference_pallas():
    """The reference's compiled tier with its Pallas kernels on (interpret
    mode on the CPU), as its own parity tests run them; the previous
    dispatch state is restored on exit."""
    state = ref_ops.pallas_state()
    ref_ops.use_pallas(True, interpret=True)
    try:
        yield
    finally:
        ref_ops.use_pallas(state[0], interpret=state[1])
