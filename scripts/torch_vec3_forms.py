"""Cost and rounding of the ways PyTorch can compute the wavefront's
three-vector primitives (dot product, cross product, normalisation) on
(N, 3) tensors.

    python scripts/torch_vec3_forms.py [--device cuda] [--out FILE]

For each primitive, every form is checked bit for bit against the kernels'
arithmetic written out component by component (each product rounded, the
sums left to right: csrc/lane.cuh with --fmad=false), on random inputs, and
timed with CUDA events (mean of 20 calls after a warm-up) at the lane
counts of the wavefront paths: 786,432 (REGEN Cornell 1024x768) and
25,165,824 (FLAT split 8 at 1024x768). On the CPU it only checks the
rounding, at 1,000,003 lanes. Prints one JSON line a lane count, and the
card's name and power limit. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch


def _ref_dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _ref_cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def _ref_n2(v):
    return (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])[:, None]


_CAT = torch.tensor([1, 2, 0, 2, 0, 1])
_CAT_B = torch.tensor([2, 0, 1, 1, 2, 0])


def _cross_gather(a, b):
    p = a[:, _CAT.to(a.device)] * b[:, _CAT_B.to(b.device)]
    return p[:, :3] - p[:, 3:]


def _cross_index_select(a, b):
    p = (a.index_select(1, _CAT.to(a.device))
         * b.index_select(1, _CAT_B.to(b.device)))
    return p[:, :3] - p[:, 3:]


def _cross_rolled(a, b):
    return (torch.roll(a, -1, 1) * torch.roll(b, 1, 1)
            - torch.roll(a, 1, 1) * torch.roll(b, -1, 1))


def _cross_rolled_once(a, b):
    # s_i = a_i b_(i+1) - a_(i+1) b_i, and (a x b)_i = s_(i+1)
    s = a * torch.roll(b, -1, 1) - torch.roll(a, -1, 1) * b
    return torch.roll(s, -1, 1)


def _cross_planes(a, b):
    (a0, a1, a2), (b0, b1, b2) = a.t().contiguous(), b.t().contiguous()
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _cross_cat(a, b):
    aa, bb = torch.cat([a, a], dim=-1), torch.cat([b, b], dim=-1)
    return aa[:, 1:4] * bb[:, 2:5] - aa[:, 2:5] * bb[:, 1:4]


def _products_summed(p):
    return p[:, 0] + p[:, 1] + p[:, 2]


FORMS = {
    "dot": (_ref_dot, {
        "sum_of_products": lambda a, b: torch.sum(a * b, dim=-1),
        "components": _ref_dot,
        "products_then_two_adds": lambda a, b: _products_summed(a * b),
    }),
    "cross": (_ref_cross, {
        "linalg_cross": lambda a, b: torch.linalg.cross(a, b),
        "components_stacked": _ref_cross,
        "doubled_slices": _cross_cat,
        "one_gather_each": _cross_gather,
        "one_index_select_each": _cross_index_select,
        "rolled": _cross_rolled,
        "rolled_once": _cross_rolled_once,
        "planes": _cross_planes,
    }),
    "norm2": (lambda a, b: _ref_n2(a), {
        "sum_of_squares": lambda a, b: torch.sum(a * a, dim=-1,
                                                 keepdim=True),
        "components": lambda a, b: _ref_n2(a),
        "squares_then_two_adds": lambda a, b: _products_summed(
            a * a)[:, None],
    }),
}


def _time_ms(fn, reps=20) -> float:
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def run(n: int, dev: torch.device, timed: bool) -> dict:
    g = torch.Generator(device="cpu").manual_seed(n)
    a = torch.randn(n, 3, generator=g) * torch.rand(n, 1, generator=g) * 8
    b = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    a, b = a.to(dev), b.to(dev)
    out = {"lanes": n, "device": dev.type}
    for prim, (ref, forms) in FORMS.items():
        want = ref(a, b)
        res = {}
        for name, fn in forms.items():
            got = fn(a, b)
            res[name] = {"bits_differ": int((got.view(torch.int32)
                                             != want.view(torch.int32))
                                            .sum())}
            if timed:
                res[name]["ms"] = _time_ms(lambda: fn(a, b))
        out[prim] = res
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_vec3_forms: no CUDA device", file=sys.stderr)
        return 1
    counts = ((786_432, 25_165_824) if dev.type == "cuda" else (1_000_003,))
    rows = [run(n, dev, dev.type == "cuda") for n in counts]
    for r in rows:
        print(json.dumps(r), flush=True)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
