"""Runtime concurrency analysis, the port's copy of the JAX package's
``analysis`` modules (its ANALYSIS.md describes them):

  * :mod:`locks`      — the lock factory: plain ``threading`` primitives
                        unless lockdep is enabled, then instrumented ones
  * :mod:`lockdep`    — the lock-order checker (AB/BA inversions, cycles,
                        locks held across blocking calls)
  * :mod:`races`      — the Eraser-style lockset detector over declared
                        shared state (``shared()``, ``register_slots()``,
                        ``shared_dict()``)
  * :mod:`interleave` — the seeded schedule explorer both hook into
"""
