"""Perf-audit helper, as in `repro.utils.audit`: the dominant collectives
and products of an analysed program, each with its multiplier (how many
times the same operation at the same call site ran) and a call-site
label in place of the HLO computation's name."""

from __future__ import annotations

__all__ = ["top_collectives", "top_dots"]


def _top(records, key: str, n: int):
    groups: dict = {}
    for r in records:
        if key not in r:
            continue
        k = (r.get("kind", r["op"]), r["site"], tuple(r["shapes"]))
        g = groups.setdefault(k, dict(raw=r[key], mult=0, site=r["site"],
                                      op=r["op"], kind=r.get("kind"),
                                      shapes=r["shapes"]))
        g["mult"] += 1
    rows = [dict(g, total=g["raw"] * g["mult"]) for g in groups.values()]
    rows.sort(key=lambda r: -r["total"])
    return rows[:n]


def top_collectives(counter, n: int = 10):
    """The `n` largest collectives by total bytes, from a
    `repro_torch.utils.hlo.ProgramCounter` (or its ``records``)."""
    return _top(getattr(counter, "records", counter), "bytes", n)


def top_dots(counter, n: int = 10):
    """The `n` largest products by total FLOPs."""
    return _top(getattr(counter, "records", counter), "flops", n)
