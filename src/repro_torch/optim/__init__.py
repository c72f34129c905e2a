from .optimizers import (Optimizer, adafactor, adamw, clip_by_global_norm,
                         compress_int8, compressed_accumulate,
                         decompress_int8, tree_leaves, tree_map,
                         warmup_cosine)
__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm",
           "compress_int8", "compressed_accumulate", "decompress_int8",
           "tree_leaves", "tree_map", "warmup_cosine"]
