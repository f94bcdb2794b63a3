"""ldpc_tpu: batched LDPC decoding framework on JAX.

Enables JAX's persistent compilation cache on import: the decode programs
(tier-switched LP solves inside cut-round while-loops) cost tens of
seconds to minutes to compile, and every CLI app / sweep process pays that
again without the on-disk cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
other directory is set here. Otherwise the cache lives at the fixed path
``<checkout>/.jax_cache``: a fixed path, because the path is part of the
cache key, and inside the checkout, which is the only directory the
package writes.
"""
import os as _os

import jax as _jax

CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
