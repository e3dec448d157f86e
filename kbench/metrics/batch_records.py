"""batch_records: records per stored batch: the records acked in the
window over the program's ``produce_tx`` spans in it (one span a
ProduceRequest, which carries one partition's batch)."""


def read(r):
    if r.spans is None or not r.delivered:
        return None
    n = sum(1 for e in r.spans if e["name"] == "produce_tx")
    return r.delivered / n if n else None
