"""Hand-written CUDA kernels for the framework's hot spots.

  segment_reduce  — relational γ group-by aggregation (fixed order: one
                    launch for one segment, two passes for more)
  join_probe      — direct-address equi-join probe (application-side join),
                    with ``build_direct_table`` building its slot table
  flash_attention — online-softmax attention (causal/SWA/chunked/GQA),
                    with its backward ``flash_attention_bwd`` for training
  rwkv6_scan      — the RWKV6 WKV recurrence from a given state, with its
                    backward ``rwkv6_scan_bwd`` for training
  adamw           — the train step's global gradient norm and its clipped
                    AdamW update and apply over every leaf (no plain
                    version here: the eager ``optim`` path is the plain
                    version, and the train step takes it off the card)

The CUDA C++ sources are in ``csrc/``, built with ``nvcc`` for ``sm_90a`` at
first use (``build.py``) and bound with ``ctypes``. Each kernel has a plain
torch version in ``ref.py`` that the wrappers take for CPU tensors;
``ops.py`` is the dispatch layer.
"""

from . import adamw, ops, ref
from .flash_attention import flash_attention, flash_attention_bwd
from .join_probe import build_direct_table, join_probe
from .rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd
from .segment_reduce import segment_reduce

__all__ = ["adamw", "ops", "ref", "segment_reduce", "join_probe",
           "build_direct_table", "flash_attention", "flash_attention_bwd",
           "rwkv6_scan", "rwkv6_scan_bwd"]
