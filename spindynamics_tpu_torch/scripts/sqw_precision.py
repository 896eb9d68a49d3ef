"""How far the float32 Lanczos S(q, omega) of the kron layout (K1) and of
the flat layout (K3) lie from their float64 recurrences, by depth: the
readings behind the limits of chip_smoke.py's flat-main cross-check.

    python -m spindynamics_tpu_torch.scripts.sqw_precision [--L 26 22]
        [--perturb 4]

Per L, from the kron ground state of the XXZ chain (Jxy=1, Jz=0.5, Sz=0,
lanc_m 40, residual 1e-3) carried to the embedded flat layout, as
flat-main does, at q = 2 pi k / L for k = 4, 7, L/2, eta 0.1, omega on
linspace(0, 4, 200). Every S is held to the float64 flat run (the plain
blocked apply) of the same depth; a reading is max |dS| / max S per q.

  steps    depths 1, 2, 6 and 60: flat float32 (K3), kron float32 through
           K1, kron float32 on the plain apply (fused=False), kron float64;
           and a faulty apply as the control: K3 with its input rounded to
           bfloat16, which is what a K1 or K3 that lost the low half of
           its operand computes. At 60 steps also each row's weight,
           |sum S / sum S64 - 1|.
  apply    one apply of phi = S^z_pi psi0: max |H phi - (H phi)_64| /
           max |(H phi)_64| through K1 and through the plain float32 apply.
  dots     60 steps with every compensated dot taken by the dot2 kernel,
           by the plain per-leaf Dot2 and by torch's float64 dot rounded to
           float32: kron against flat, and each against float64.
  ulps     --perturb states with 4096 non-zero amplitudes of the largest
           leaf moved by one float32 ulp (state 0 unmoved): kron against
           flat at 60 steps, and each row's weight, with the kernel and
           with Dot2.

The dots are swapped by rebinding utils.compensated.dot2_leaves for the
length of one run, which every solver of this process then sees: this
script runs nothing else. One JSON line per reading, then one with the
card. With no CUDA device it exits non-zero before it prints anything.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from ..utils.profiling import card_info

DEPTHS = (1, 2, 6, 60)
ETA = 0.1


@contextlib.contextmanager
def _dots(fn):
    """Every compensated dot of the solvers taken by `fn` inside the
    block."""
    from ..utils import compensated as comp

    keep = comp.dot2_leaves
    comp.dot2_leaves = fn
    try:
        yield
    finally:
        comp.dot2_leaves = keep


def _f64_dot(xs, ys):
    """torch's float64 dot of each leaf pair, summed, rounded to float32."""
    return sum(torch.dot(a.reshape(-1).double(), b.reshape(-1).double())
               for a, b in zip(xs, ys)).float()


def _to_flat(psi, lay, dev):
    """The 2^L flat amplitudes (bit i = site i) of a kron BlockVec."""
    from ..ops import sector_kron as sk

    states = sk.kron_order_states(lay.L, lay.nup, lay.splits, lay.pads)
    real = torch.as_tensor(states != sk.PAD_SENTINEL, device=dev)
    idx = torch.as_tensor(states.astype(np.int64), device=dev)
    out = torch.zeros(1 << lay.L, dtype=psi.dtype, device=dev)
    out[idx[real]] = sk.blocks_to_flat(psi.leaves, lay)[real]
    return out


def _rows(a, ref):
    return [float(np.abs(a[i] - ref[i]).max()) / float(ref.max())
            for i in range(ref.shape[0])]


def _weights(a, ref):
    return [float(x) for x in np.abs(a.sum(axis=1) / ref.sum(axis=1) - 1.0)]


def _bf16_input(mv):
    """The apply `mv` of its input rounded to bfloat16 (the control)."""
    def apply(x):
        r = torch.view_as_real(x) if x.is_complex() else x
        r = r.to(torch.bfloat16).float()
        return mv(torch.view_as_complex(r) if x.is_complex() else r)
    return apply


def probe(L: int, n_perturb: int, dev) -> None:
    import spindynamics_tpu_torch as pt
    from ..observables_kron import bv_sz_q_apply, bv_sz_q_weights
    from ..utils import compensated as comp

    qs = [2 * np.pi * k / L for k in (4, 7, L // 2)]
    omega = np.linspace(0.0, 4.0, 200)
    mk = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2)
    mk64 = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, dtype=torch.float64)
    m = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, layout="embedded")
    m64 = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, layout="embedded",
                       dtype=torch.float64)
    Ek, psik, _, lay = pt.groundstate_kron(mk, lanc_m=40, cycles=6,
                                           target_residual=1e-3, device=dev)
    psif = _to_flat(psik, lay, dev)
    mv = pt.matvec_fn(m, device=dev)

    def kron(depth, psi=psik, fused=True, model=mk):
        return pt.lanczos_sqw_kron(model, qs, omega, lanc_m=depth, eta=ETA,
                                   psi0=psi, E0=Ek, fused=fused)[0]

    def flat(depth, psi=psif, matvec=mv):
        return pt.lanczos_sqw(psi, m, qs, omega, lanc_m=depth, eta=ETA,
                              matvec=matvec)

    def flat64(depth):
        return pt.lanczos_sqw(psif.double(), m64, qs, omega, lanc_m=depth,
                              eta=ETA, backend="blocked")

    def emit(**rec):
        print(json.dumps({"L": L, **rec}), flush=True)

    ref60 = None
    for depth in DEPTHS:
        ref = flat64(depth)
        runs = {"flat K3": flat(depth), "kron K1": kron(depth),
                "kron plain": kron(depth, fused=False),
                "kron float64": kron(depth, psik.map(lambda x: x.double()),
                                     False, mk64),
                "control": flat(depth, matvec=_bf16_input(mv))}
        rec = {k: _rows(S, ref) for k, S in runs.items()}
        if depth == DEPTHS[-1]:
            ref60 = ref
            rec["weight"] = {k: _weights(S, ref) for k, S in runs.items()}
        emit(steps=depth, **rec)

    # one apply of phi = S^z_pi psi0 (real at q = pi)
    phi, _ = bv_sz_q_apply(psik, bv_sz_q_weights(lay, float(np.pi)))
    y64 = pt.KronHamiltonian(lay, dtype=torch.float64, device=dev,
                             fused=False)(phi.map(lambda x: x.double()))
    ymax = max(float(x.abs().max()) for x in y64.leaves)
    rec = {}
    for name, fused in (("kron K1", True), ("kron plain", False)):
        y = pt.KronHamiltonian(lay, dtype=torch.float32, device=dev,
                               fused=fused)(phi)
        rec[name] = max(float((a.double() - b).abs().max())
                        for a, b in zip(y.leaves, y64.leaves)) / ymax
    emit(apply_q_pi=rec)

    dots = {"dot2": comp.dot2_leaves, "Dot2": comp.dot2_leaves_plain,
            "torch float64": _f64_dot}
    rec = {}
    for name, fn in dots.items():
        with _dots(fn):
            Sk, Sf = kron(60), flat(60)
        rec[name] = {"kron vs flat": _rows(Sk, Sf),
                     "kron": _rows(Sk, ref60), "flat": _rows(Sf, ref60)}
    emit(dots=rec)

    big = max(range(len(psik.leaves)), key=lambda j: psik.leaves[j].numel())
    for i in range(n_perturb):
        leaves = [x.clone() for x in psik.leaves]
        if i:
            g = leaves[big].view(-1)[i * 99991:i * 99991 + 4096]
            g.copy_(torch.where(g != 0, torch.nextafter(
                g, torch.full_like(g, 2)), g))
        pk = pt.BlockVec(leaves)
        pf = _to_flat(pk, lay, dev)
        rec = {}
        for name in ("dot2", "Dot2"):
            with _dots(dots[name]):
                Sk, Sf = kron(60, pk), flat(60, pf)
            rec[name] = {"kron vs flat": _rows(Sk, Sf),
                         "weight": _weights(Sk, Sf)}
        emit(ulps=i, **rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--L", type=int, nargs="+", default=[26])
    ap.add_argument("--perturb", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe measures the card's "
                         "kernels only")
    dev = torch.device("cuda")
    card = card_info()
    for L in args.L:
        probe(L, args.perturb, dev)
    print(json.dumps({"device": {k: card[k] for k in (
        "name", "count", "power_limit_w")}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
