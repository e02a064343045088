"""Roofline share of the switch pipeline, `SwitchCore.alloc` (window
desires, the `alloc.cu` rounds, arrivals, compaction), in %: the bytes
of the allocation's inputs and outputs (`roofline.alloc_bytes`, every
lane) at the HBM peak, over the pipeline's device time per call."""

from sfbench import roofline

SPAN = ("sfbench.switch", "repro_torch.sim:SwitchCore.alloc")


def before(core, args, kwargs, rec):
    rec["shape"] = (core.L, core.N, core.P, core.V, core.p, core.W)
    return args, kwargs


def read(run):
    t = run["trace"]
    span = t and t["spans"].get(SPAN[0])
    recs = (t or {}).get("records", {}).get(SPAN[0], [])
    if not span or not span["calls"] or not recs:
        return None
    nbytes = sum(roofline.alloc_bytes(*r["shape"]) for r in recs) / len(recs)
    return roofline.share_pct(nbytes, span["device_s"] / span["calls"])
