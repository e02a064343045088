"""Bit-packed flit records, ported from `repro.sim.packed`.

Every record is ``PK = 3`` int32 words:

  word 0   dst_router | inter_router << 16   (15 bits each)
  word 1   inject_cycle                      (full int32)
  word 2   hops | phase << 6 | msg << 7      (6 / 1 / 24 bits)

Field budgets (asserted by the engine): router ids < 2**15, hops
saturate at 63, msg ids < 2**24 (split as job << 18 | local id; a
single job has job bits 0).  Every word and every accessor stays int32:
torch's `>>` on an int32 tensor is arithmetic like jnp's, and word 0 is
non-negative, so `pk_inter` is an exact field extract.
"""

from __future__ import annotations

import torch

__all__ = [
    "PK", "HOPS_MAX", "MAX_ROUTERS", "MAX_MSGS",
    "MSG_JOB_SHIFT", "MAX_JOBS", "MAX_JOB_MSGS",
    "pack_record", "bump_hops_word",
    "pk_dst", "pk_inter", "pk_time", "pk_hops", "pk_phase", "pk_msg",
    "pk_flow_key",
]

PK = 3                      # int32 words per packed record
HOPS_MAX = 63               # saturating hop counter (6 bits)
MAX_ROUTERS = 1 << 15       # router ids must fit 15 bits
MAX_MSGS = 1 << 24          # closed-loop msg ids must fit 24 bits

MSG_JOB_SHIFT = 18
MAX_JOBS = 1 << (24 - MSG_JOB_SHIFT)        # 64 concurrent jobs
MAX_JOB_MSGS = 1 << MSG_JOB_SHIFT           # 262144 messages per job


def pack_record(dst, inter, time: int, hops, phase, msg=None):
    """Stack fields into a packed [..., PK] int32 record; `time` is the
    host cycle number, broadcast to every record."""
    w0 = dst | (inter << 16)
    w2 = hops | (phase << 6)
    if msg is not None:
        w2 = w2 | (msg << 7)
    w1 = torch.full_like(w0, time)
    out = torch.stack([w0, w1, w2], dim=-1)
    assert out.dtype == torch.int32, out.dtype
    return out


def pk_dst(pkt):
    return pkt[..., 0] & 0xFFFF


def pk_inter(pkt):
    # word 0 is non-negative (ids < 2**15), so the arithmetic shift of
    # the int32 word is an exact field extract
    return pkt[..., 0] >> 16


def pk_time(pkt):
    return pkt[..., 1]


def pk_hops(pkt):
    return pkt[..., 2] & HOPS_MAX


def pk_phase(pkt):
    return (pkt[..., 2] >> 6) & 1


def pk_msg(pkt):
    return pkt[..., 2] >> 7


def bump_hops_word(w2, set_phase):
    """word-2 update on link traversal: hops+1 (saturating at HOPS_MAX),
    phase |= set_phase; msg bits carried through untouched."""
    hops = torch.clamp((w2 & HOPS_MAX) + 1, max=HOPS_MAX)
    phase = ((w2 >> 6) & 1) | set_phase
    rest = (w2 >> 7) << 7
    return rest | hops | (phase << 6)


def pk_flow_key(pkt):
    """Hop-invariant identity of a packet: (word 0, word 1), the
    destination and intermediate routers and the inject cycle, which
    `bump_hops_word` never touches (the open-loop trace sampler's key)."""
    return pkt[..., 0], pkt[..., 1]
