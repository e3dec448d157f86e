"""Static and runtime concurrency analysis, the port's copy of the JAX
package's ``analysis`` modules (its ANALYSIS.md describes them):

  * :mod:`locks`      — the lock factory: plain ``threading`` primitives
                        unless lockdep is enabled, then instrumented ones
  * :mod:`lockdep`    — the lock-order checker (AB/BA inversions, cycles,
                        locks held across blocking calls)
  * :mod:`races`      — the Eraser-style lockset detector over declared
                        shared state (``shared()``, ``register_slots()``,
                        ``shared_dict()``)
  * :mod:`interleave` — the seeded schedule explorer both hook into
  * :mod:`lint`       — the AST lint of the project's invariants over the
                        port (``lint_package()``)
  * :mod:`stress`     — the runtime gate: ``run_stress(device=None)``
                        (every leg under lockdep) and ``run_races()`` (the
                        lockset sweep and seeded schedules); the device
                        legs run on the card unless ``device="cpu"``

Gate: ``python -m librdkafka_tpu_torch.analysis [lint|stress|races|all]
[--device cuda|cpu]`` exits nonzero on any finding.
"""
