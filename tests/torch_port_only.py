"""What the port records beyond the JAX package: the stats fields and
the trace events and span args of the port's own
``librdkafka_tpu_torch/CPU_ACCOUNTING.md`` (the client's CPU by layer).
The mirrors compare the two packages with these taken out of the port's
side and hold them present there."""
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC = os.path.join(ROOT, "librdkafka_tpu_torch", "CPU_ACCOUNTING.md")

#: the port's own trace events and span args (the doc's "Trace events")
EVENTS = {"pass_tally", "codec_tally", "dr"}
SPAN_ARGS = {"batch"}

_HEAD = "## Stats: "


def stats_fields() -> dict:
    """{stats path: field names} of the doc's "Stats" sections
    (``## Stats: brokers.{name}``), read as test_0053 reads STATISTICS.md:
    the backticked tokens of a table row's first column."""
    out: dict = {}
    cur = None
    with open(DOC) as f:
        for line in f:
            if line.startswith("## "):
                cur = (line[len(_HEAD):].strip()
                       if line.startswith(_HEAD) else None)
                if cur is not None:
                    out[cur] = set()
            elif cur is not None and line.startswith("|"):
                first = line.split("|")[1]
                for tok in re.findall(r"`([^`]+)`", first):
                    out[cur].add(tok.strip().rstrip("{}"))
    return out


def _without(d: dict, keys: set) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


def strip_stats(tree: dict) -> dict:
    """A stats blob (or its key tree) without the port-only fields, after
    checking that the port's blob carries every one of them."""
    fields = stats_fields()
    out = dict(tree)
    want = fields["brokers.{name}"]
    b = out.get("brokers")
    for x in (b.values() if isinstance(b, dict) else b or []):
        assert want <= set(x), want - set(x)
    if isinstance(b, dict):
        out["brokers"] = {n: _without(x, want) for n, x in b.items()}
    elif isinstance(b, list):
        out["brokers"] = [_without(x, want) for x in b]
    eos = out.get("eos")
    if isinstance(eos, dict) and "txn_state" in eos:
        # the transactional producer's counters
        want = fields["eos"]
        assert want <= set(eos), want - set(eos)
        out["eos"] = _without(eos, want)
    if "codec_engine" in out:
        want = fields["codec_engine"]
        assert want <= set(out["codec_engine"]), \
            want - set(out["codec_engine"])
        out["codec_engine"] = _without(out["codec_engine"], want)
        comp = out["codec_engine"].get("compress")
        if isinstance(comp, dict):
            want = fields["codec_engine.compress"]
            assert want <= set(comp), want - set(comp)
            out["codec_engine"]["compress"] = _without(comp, want)
    return out
