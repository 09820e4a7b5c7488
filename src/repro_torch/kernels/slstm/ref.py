"""Plain PyTorch version of the sLSTM's recurrence over time: the port of
the body of JAX's ``lax.scan`` at ``repro.models.xlstm._slstm_block_full``
(the einsum with ``R``, then ``_slstm_cell``) and of the gradient JAX's
autodiff takes of it.

Gate block ``hd`` of ``g`` (z, i, f, o for hd = 0..3, each ``d`` wide)
adds ``h[:, hd·d/4:(hd+1)·d/4] @ R[hd]``: z reads only head 0 of h, i only
head 1, f only head 2 and o only head 3 (``rec.reshape(B, -1)`` flattens
(head, e)).  Every state is float32.

``slstm_scan_ref`` is the loop the model ran before the kernels; with
``save`` it also returns what the backward reads (the gate
pre-activations and the c, n, m states of every step).
``slstm_bwd_ref`` is the gradient of that loop derived by hand, step by
step backward, op for op as ``csrc/slstm.cu``'s backward computes it.  At
``m' = max(logf + m, i)`` and ``max(n, 1)`` a tie sends half the gradient
down each branch, as ``jnp.maximum`` (and ``torch.maximum``) do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.models import layers as L

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class Saved(NamedTuple):
    """What the forward keeps for the backward, every step's."""

    g: torch.Tensor  # (B, S, 4d) the gate pre-activations wx_t + rec(h_{t−1})
    c: torch.Tensor  # (B, S, d) c_t
    n: torch.Tensor  # (B, S, d) n_t
    m: torch.Tensor  # (B, S, d) m_t


def zero_state(B: int, d: int, device) -> State:
    return tuple(torch.zeros((B, d), dtype=torch.float32, device=device) for _ in range(4))


def recurrent(h: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """rec(h): (B, d) → (B, 4d), gate block hd = h's head hd @ R[hd]."""
    B = h.shape[0]
    return torch.einsum("bhd,hde->bhe", h.reshape(B, 4, -1), R).reshape(B, -1)


def slstm_cell(state: State, g: torch.Tensor):
    """state (h, c, n, m), each (B,d) f32; g (B,4d) f32 → (new state, h)."""
    _h, c, n, m = state
    z, i, f, o = g.chunk(4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    logf = L.log_sigmoid(f)
    m_new = torch.maximum(logf + m, i)
    iprime = torch.exp(i - m_new)
    fprime = torch.exp(logf + m - m_new)
    c = fprime * c + iprime * z
    n = fprime * n + iprime
    h = o * c / L.maximum(n, 1.0)
    return (h, c, n, m_new), h


def slstm_step_ref(state: State, wx_t: torch.Tensor, R: torch.Tensor):
    """One step: (new state, h_t) from the state and wx_t (B, 4d)."""
    return slstm_cell(state, wx_t + recurrent(state[0], R))


def slstm_scan_ref(wx: torch.Tensor, R: torch.Tensor, state: Optional[Sequence] = None,
                   save: bool = False):
    """wx (B, S, 4d) f32, R (4, d/4, d) f32, state (h, c, n, m) each (B, d)
    f32 (zeros when None) → (hs (B, S, d), the last state), and with
    ``save`` also ``Saved``.  Runs under the caller's grad mode."""
    B, S = wx.shape[:2]
    d = R.shape[-1]
    state = zero_state(B, d, wx.device) if state is None else tuple(state)
    hs, gs, cs, ns, ms = [], [], [], [], []
    for t in range(S):
        g = wx[:, t] + recurrent(state[0], R)
        state, h = slstm_cell(state, g)
        hs.append(h)
        if save:
            gs.append(g)
            cs.append(state[1])
            ns.append(state[2])
            ms.append(state[3])
    out = torch.stack(hs, 1)
    if not save:
        return out, state
    return out, state, Saved(*(torch.stack(x, 1) for x in (gs, cs, ns, ms)))


def _tie_split(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The share of max(x, y)'s gradient that goes to x: 1, ½ at a tie, 0."""
    return (x > y).float() + 0.5 * (x == y).float()


def slstm_dR(hs: torch.Tensor, dG: torch.Tensor) -> torch.Tensor:
    """dR = Σ_t h_{t−1}ᵀ·dg_t per head over all B·S rows, one batched
    product: (4, d/4, d) from hs (B, S, d) and dG (B, S, 4d), h_{−1} = 0."""
    B, S, d = hs.shape
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], 1).reshape(B * S, 4, d // 4)
    return torch.bmm(h_prev.permute(1, 2, 0), dG.reshape(B * S, 4, d).permute(1, 0, 2))


def slstm_bwd_ref(dhs: torch.Tensor, R: torch.Tensor, hs: torch.Tensor, saved: Saved):
    """The gradient of ``slstm_scan_ref(wx, R)``'s ``hs`` (from the zero
    state) against ``dhs`` (B, S, d): (dwx (B, S, 4d), dR (4, d/4, d)).
    ``hs`` and ``saved`` are the forward's.  Step t = S−1..0 forms dh_t =
    dhs_t + dg_{t+1}·Rᵀ (per head), runs the cell backward with the
    carried dc, dn, dm and writes dg_t (= dwx_t); dR = Σ_t h_{t−1}ᵀ·dg_t is
    one product after the loop (``slstm_dR``)."""
    B, S, d = hs.shape
    zero = torch.zeros((B, d), dtype=torch.float32, device=hs.device)
    dG = torch.empty((B, S, 4 * d), dtype=torch.float32, device=hs.device)
    dc = dn = dm = zero
    for t in range(S - 1, -1, -1):
        dh = dhs[:, t]
        if t < S - 1:
            nxt = dG[:, t + 1].reshape(B, 4, d)
            dh = dh + torch.einsum("bhe,hke->bhk", nxt, R).reshape(B, d)
        zr, ir, fr, orr = saved.g[:, t].chunk(4, dim=-1)
        c, n, m = saved.c[:, t], saved.n[:, t], saved.m[:, t]
        c_p, n_p, m_p = ((zero, zero, zero) if t == 0
                         else (saved.c[:, t - 1], saved.n[:, t - 1], saved.m[:, t - 1]))
        z = torch.tanh(zr)
        o = torch.sigmoid(orr)
        logf = L.log_sigmoid(fr)
        a = logf + m_p
        ip = torch.exp(ir - m)
        fp = torch.exp(a - m)
        nc = L.maximum(n, 1.0)
        h = o * c / nc
        t1 = dh / nc                      # d(o·c)
        do = t1 * c
        dct = dc + t1 * o
        dnt = dn - (t1 * h) * _tie_split(n, torch.ones_like(n))
        dfp = dct * c_p + dnt * n_p
        dip = dct * z + dnt
        dz = dct * ip
        dc, dn = dct * fp, dnt * fp       # the carries into step t − 1
        da_arg = dfp * fp                 # d(a − m)
        di_arg = dip * ip                 # d(i − m)
        dmt = dm - da_arg - di_arg
        wa = _tie_split(a, ir)
        da = da_arg + dmt * wa
        dir_ = di_arg + dmt * (1.0 - wa)
        dm = da                           # a = logf + m_{t−1}
        dfr = da * torch.exp(logf - fr)   # d log σ(f) = σ(−f) = exp(log σ(f) − f)
        dor = do * o * (1.0 - o)
        dzr = dz * (1.0 - z * z)
        dG[:, t] = torch.cat([dzr, dir_, dfr, dor], -1)
    return dG, slstm_dR(hs, dG)
