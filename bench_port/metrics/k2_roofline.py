"""K2's share of its roofline, in %: the least time the H100 could take
for the bytes the WL hash needs, over K2's kernel time a call (the
profiler's records named ``wl_hash``).

Bytes, counted from the graphs' own sizes (no padding): each of the
``n_iter`` refinements reads each vertex's label and CSR offset (and one
offset more) once and writes its 8-byte key once, and reads each
directed edge's target once, all as 4-byte integers.  The bound is
bytes over 3.35 TB/s (``peaks.json``: the H100 SXM datasheet's HBM rate
at its 700 W limit; the run's ``device.power_limit_w`` gives the card's
own).  The hash's integer work is far below its bytes' time."""


def bytes_needed(vertices, directed_edges, n_iter):
    return n_iter * (4 * vertices + 4 * (vertices + 1) + 8 * vertices
                     + 4 * directed_edges)


def read(run):
    t = run.timeline
    if t is None or not run.calls:
        return None
    k2 = t.seconds(lambda name: "wl_hash" in name) / len(run.calls)
    if k2 <= 0:
        return None
    need = bytes_needed(run.stats["vertices"], run.stats["directed_edges"],
                        run.cfg["kernel"]["params"]["n_iter"])
    return 100.0 * need / run.peaks["hbm_bytes_per_s"] / k2
