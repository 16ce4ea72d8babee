"""How far the bf16 flash backward kernels sit from their rounding model
(``ops.flash_attention.plain_flash_backward_bf16``) over many seeded
inputs: for each seed, the three ``bf16_ulps`` readings the chip
script's check holds to 1 (``chip_smoke.check_flash``) — with the
model's flip bounds (``bf16_flip_bounds``) at each relative error in
``--rels``, and without them — and the unrounded plain version's
reading of the same check (the control: above 1 where the check sees
the rounding); where a reading passes 1, the worst element's kernel,
model and plain values.

Run on a card from the repository root::

    python3 probe_flash_model.py [--seeds 32] [--batches 16,32]
        [--rels 20,18,16]

It builds the flash kernels from the checkout, prints one JSON line per
seed and bound past 1 and one summary line per batch size and bound
(the training path's shape: T=256, H=8, D=64, key-masked, bf16), and
exits 0.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def worst(got, want, plain, bound):
    import importlib
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    w, g, p = want.float(), got.float(), plain.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    slack = fa.BF16_MODEL_FLOOR * float(w.abs().max())
    b = torch.zeros_like(w) if bound is None else bound
    u = (g - w).abs() / (ulp + slack + b)
    i = int(u.argmax())
    return {"got": float(g.reshape(-1)[i]), "model": float(w.reshape(-1)[i]),
            "plain": float(p.reshape(-1)[i]), "over_1": int((u > 1).sum()),
            "ulp": float(ulp.reshape(-1)[i]), "slack": slack,
            "bound": float(b.reshape(-1)[i])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--batches", default="16,32")
    ap.add_argument("--rels", default="20,18,16",
                    help="flip-bound relative errors, as n of 2**-n")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_flash_model: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    import importlib
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    fa.build()
    # None: the floor alone (no flip bound)
    rels = [None] + [2.0 ** -int(n) for n in args.rels.split(",")]
    for B in (int(b) for b in args.batches.split(",")):
        rows = {r: [] for r in rels}
        for seed in range(100, 100 + args.seeds):
            q, k, v, do, mask = cs.flash_inputs(B, 256, 256, 8, 64, True,
                                                torch.bfloat16, seed)
            o, lse = fa.flash_fwd(q, k, v, False, None, mask)
            dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, False, None,
                                        mask)
            dk, dv = fa.flash_bwd_dkv(q, k, v, lse, delta, do, False, None,
                                      mask)
            model = fa.plain_flash_backward_bf16(q, k, v, o, lse, do, False,
                                                 None, mask)
            plain = fa.plain_flash_backward(q, k, v, o, lse, do, False,
                                            None, mask)
            for rel in rels:
                bounds = (None,) * 3 if rel is None else fa.bf16_flip_bounds(
                    q, k, v, o, lse, do, False, None, mask, rel=rel)
                row = {"B": B, "seed": seed, "rel": rel}
                for n, got, want, ref, b in zip(
                        ("dq", "dk", "dv"), (dq, dk, dv), model, plain,
                        bounds):
                    row[n] = fa.bf16_ulps(got, want, b)
                    row[n + "_control"] = fa.bf16_ulps(ref, want, b)
                    if row[n] > 1:
                        row[n + "_worst"] = worst(got, want, ref, b)
                rows[rel].append(row)
                if max(row["dq"], row["dk"], row["dv"]) > 1:
                    print(json.dumps(row), flush=True)
                del bounds
        for rel in rels:
            rs = rows[rel]
            print(json.dumps({
                "B": B, "rel": rel, "seeds": len(rs), "card": cs.card_line(),
                "over_1": sum(max(r["dq"], r["dk"], r["dv"]) > 1 for r in rs),
                "max": {n: max(r[n] for r in rs) for n in ("dq", "dk", "dv")},
                # the check sees the rounding on a seed where the control
                # passes 1 for one of the three
                "control_min_of_max": min(
                    max(r["dq_control"], r["dk_control"], r["dv_control"])
                    for r in rs)}), flush=True)


if __name__ == "__main__":
    main()
