"""The device's idle share, in %: 1 - busy / wall over a stretch of the
cell's requests. Busy: the union of device activity in a torch.profiler
trace of the stretch that records device activity alone. Wall: the same
requests run just before it unprofiled, since the profiler slows the host
and so stretches a host-paced wall."""


def read(r):
    p = r.profile
    if not p or p.get("plain_s", 0) <= 0 or p["busy_s"] <= 0:
        return None
    return (1 - p["busy_s"] / p["plain_s"]) * 100
