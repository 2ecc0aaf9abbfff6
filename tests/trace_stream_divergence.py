"""Where the port's streaming path and the JAX package's part ways, lane by
lane, at Cornell 16x12 (test_torch_streaming.py's configuration).

Both run one iteration a launch from a fresh state with a budget of 4 until
drained: JAX stream_step (Pallas interpreter) and the port's
stream_step_plain, each from its own state (chained), and the port from
JAX's state after every iteration (one step). For every lane whose chained
discrete state (depth, s_idx, alive, rays) ever differs, it prints the
iterations up to the first difference, with both origins and the largest
origin and direction differences; then every one-step lane-step whose new
direction differs by more than 1e-4.

    JAX_PLATFORMS=cpu python tests/trace_stream_divergence.py [SEED ...]
"""

import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from test_torch_streaming import (  # noqa: E402
    G, _planes, _port_inputs, jax_iterations, tmk, trng,
)


def trace(seed: int) -> None:
    steps, cfg, scene = jax_iterations(seed)
    table, cam = _port_inputs(cfg, scene)
    key = trng.base_key(seed)
    tf, ti = tmk.init_stream_state(cfg, device="cpu")
    chained, one = [], []
    for n, (jf, ji) in enumerate(steps):
        tmk.stream_step(table, cam, cfg, key, tf, ti, None if n else 4, 1,
                        n_spheres=scene.n_spheres)
        chained.append(_planes(tf.clone(), ti.numpy().copy()))
        if n:
            f1, i1 = tmk.state_from_jax(*steps[n - 1], device="cpu")
            tmk.stream_step(table, cam, cfg, key, f1, i1, None, 1,
                            n_spheres=scene.n_spheres)
            one.append(_planes(f1, i1.numpy()))
    jax = [_planes(f, i) for f, i in steps]
    print(f"seed {seed}: {len(steps)} iterations to drain")
    for lane in range(G):
        diff = [k for k, ((_, ij), (_, ip)) in enumerate(zip(jax, chained))
                if (ij[:4, lane] != ip[:4, lane]).any()]
        if not diff:
            continue
        first = diff[0]
        print(f"  lane {lane}: discrete state first differs after iteration "
              f"{first + 1}; rays {int(jax[-1][1][3, lane])} (JAX) vs "
              f"{int(chained[-1][1][3, lane])} (port) once drained")
        for k in range(first + 1):
            (fj, ij), (fp, ip) = jax[k], chained[k]
            do = np.abs(fj[0:3, lane] - fp[0:3, lane]).max()
            dd = np.abs(fj[3:6, lane] - fp[3:6, lane]).max()
            if k >= first - 3 or do > 0.02 or dd > 1e-5:
                print(f"    after {k + 1:2d}: depth {ij[0, lane]}/{ip[0, lane]}"
                      f" alive {ij[2, lane]}/{ip[2, lane]} origin JAX "
                      f"{np.round(fj[0:3, lane], 3)} port "
                      f"{np.round(fp[0:3, lane], 3)} |d origin| {do:.3g} "
                      f"|d direction| {dd:.3g}")
    for k, (fp, ip) in enumerate(one):
        fj, ij = jax[k + 1]
        for lane in np.nonzero(
                (np.abs(fp[3:6] - fj[3:6]).max(0) > 1e-4) & (ij[2] != 0))[0]:
            print(f"  one step from JAX's state after iteration {k + 1}, lane "
                  f"{lane}: from origin {np.round(jax[k][0][0:3, lane], 3)}, "
                  f"JAX reaches {np.round(fj[0:3, lane], 3)}, the port "
                  f"{np.round(fp[0:3, lane], 3)}")


if __name__ == "__main__":
    for s in sys.argv[1:] or ["0", "1"]:
        trace(int(s))
