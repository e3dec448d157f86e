"""device_job_share: codec jobs launched on the card, as a share of
every codec job the offload engines took in the window: CRC jobs
(produce tickets, fetch verify) and compress jobs, and the host jobs
(lz4 compress or decompress on the host).  CRC jobs the engine served
on the CPU (below its launch quorum, routed there by the governor, or
before the kernel was warm) count as not launched."""


def read(r):
    e = r.engine
    if not e:
        return None
    crc_dev = e.get("jobs", 0) - (e.get("cpu_fallback_jobs", 0)
                                  + e.get("routed_cpu_jobs", 0)
                                  + e.get("warmup_miss_jobs", 0))
    comp = e.get("compress_jobs", 0)
    comp_dev = comp - (e.get("compress_cpu_jobs", 0)
                       + e.get("compress_routed_cpu_jobs", 0)
                       + e.get("compress_warmup_miss_jobs", 0)
                       + e.get("compress_shed_jobs", 0))
    total = e.get("jobs", 0) + comp + e.get("host_jobs", 0)
    return 100.0 * (crc_dev + comp_dev) / total if total else None
