"""txn_cpu_us: the CPU the copiers' threads spent inside the program's
transaction API (``begin_transaction``, ``send_offsets_to_transaction``,
``commit_transaction``, ``abort_transaction`` with the coordinator
requests they wait on and the flush of a commit: the program's
``txn_cpu_ns``, counted while tracing), summed over the transactional
producers, per record whose transaction committed in the window.  A
program without the counter, or an untraced run, has none."""


def read(r):
    txn = r.extra.get("txn") or {}
    if r.spans is None or not r.delivered or "txn_cpu_ns" not in txn:
        return None
    return txn["txn_cpu_ns"] / 1e3 / r.delivered
