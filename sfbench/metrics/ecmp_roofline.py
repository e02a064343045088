"""Roofline share of the ECMP choice, `SwitchCore.ecmp_port` (plain
PyTorch), in %: the bytes it needs (`roofline.ecmp_bytes`: targets in,
ports out, each distinct (router, target) row of the equal-cost table
and the credit view read once) at the HBM peak, over its device time per
call."""

import torch

from sfbench import roofline

SPAN = ("sfbench.ecmp_choice", "repro_torch.sim:SwitchCore.ecmp_port")


def before(core, args, kwargs, rec):
    rec.update(router=args[0], tgt=args[1], occ_entries=args[2].numel(),
               N=core.N, width=core.ecmp_rows.shape[1])
    return args, kwargs


def read(run):
    t = run["trace"]
    span = t and t["spans"].get(SPAN[0])
    recs = (t or {}).get("records", {}).get(SPAN[0], [])
    if not span or not span["calls"] or not recs:
        return None
    total = 0
    for r in recs:
        tgt = r["tgt"].long()
        rows = r["router"].long().expand(tgt.shape) * r["N"] + tgt
        total += roofline.ecmp_bytes(tgt.numel(), int(torch.unique(rows).numel()),
                               r["width"], r["occ_entries"])
    return roofline.share_pct(total / len(recs), span["device_s"] / span["calls"])
