"""CLI: ``python -m librdkafka_tpu_torch.analysis [lint|stress|races|all]
[--device cuda|cpu]``.

``lint``   — AST project-invariant lint over the package (lint.py)
``stress`` — lockdep-enabled stress pass (stress.py)
``races``  — lockset data-race sweep + seeded schedule explorer
             (races.py / interleave.py via stress.py legs)
``all``    — everything; exit 1 on any finding

``--device`` is the device of the stress and races passes' device legs:
``cuda`` (the default; they raise without a card) or ``cpu`` (the
kernels' plain versions).
"""
import sys


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv) or argv[i + 1] not in ("cuda", "cpu"):
            print(__doc__)
            return 2
        device = argv[i + 1]
        del argv[i:i + 2]
    cmd = argv[0] if argv else "all"
    if cmd not in ("lint", "stress", "races", "all"):
        print(__doc__)
        return 2
    rc = 0
    if cmd in ("lint", "all"):
        from .lint import main as lint_main
        rc |= lint_main(argv[1:] if cmd == "lint" else [])
    if cmd in ("stress", "all"):
        from .stress import main as stress_main
        rc |= stress_main(device)
    if cmd in ("races", "all"):
        from .stress import races_main
        rc |= races_main(device)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
