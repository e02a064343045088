"""Roofline share of the route choice, `SwitchCore.route_decision`
(UGAL-L: the candidates' draw and `ugal_route`), in %: the bytes it
needs (`roofline.ugal_route_bytes`, every lane) at the HBM peak, over
its device time per call."""

from sfbench import roofline

SPAN = ("sfbench.route_choice", "repro_torch.sim:SwitchCore.route_decision")


class _Recording:
    """The call's random source, keeping the route draw it hands out."""

    def __init__(self, source, rec):
        self._source, self._rec = source, rec

    def randint(self, stream, shape, low, high):
        out = self._source.randint(stream, shape, low, high)
        if stream == "route":
            self._rec["cands"] = out
        return out

    def __getattr__(self, name):
        return getattr(self._source, name)


def before(core, args, kwargs, rec):
    args = list(args)
    if len(args) > 2:
        args[2] = _Recording(args[2], rec)
    else:
        kwargs = dict(kwargs, source=_Recording(kwargs["source"], rec))
    rec["core"], rec["dst_r"] = core, args[0]
    return tuple(args), kwargs


def read(run):
    t = run["trace"]
    span = t and t["spans"].get(SPAN[0])
    recs = [r for r in (t or {}).get("records", {}).get(SPAN[0], [])
            if "cands" in r]
    if not span or not span["calls"] or not recs:
        return None
    total = 0
    for r in recs:
        core, dst = r["core"], r["dst_r"]
        for lane in range(dst.shape[0]):
            total += roofline.ugal_route_bytes(core.ep_router, dst[lane],
                                         r["cands"][lane], core.dist,
                                         core.port_toward)
    return roofline.share_pct(total / len(recs), span["device_s"] / span["calls"])
