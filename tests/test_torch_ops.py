"""The PyTorch port's shading and intersection math (ops/bsdf.py,
ops/intersect.py, core/math.py) and its accumulation and stats helpers
(engine/accum.py, utils/metrics.py) against the JAX package's on the same
numpy inputs. Tolerance: a few float32 ulp (XLA:CPU and PyTorch may round
transcendental functions and contracted sums differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallpt_tpu.core import math as jmath
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.engine import accum as jaccum
from smallpt_tpu.ops import bsdf as jbsdf
from smallpt_tpu.ops import intersect as jisect
from smallpt_tpu.utils import metrics as jmetrics
from smallpt_tpu_torch.core import math as tmath
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.engine import accum as taccum
from smallpt_tpu_torch.ops import bsdf as tbsdf
from smallpt_tpu_torch.ops import intersect as tisect
from smallpt_tpu_torch.utils import metrics as tmetrics


def _unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_math_helpers_match():
    x = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    x[0] = 0.0
    np.testing.assert_allclose(tmath.safe_sqrt(_t(x)).numpy(),
                               np.asarray(jmath.safe_sqrt(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tmath.safe_normalize(_t(x)).numpy(),
        np.asarray(jmath.safe_normalize(jnp.asarray(x))), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(
        tmath.safe_div(_t(x), _t(x[::-1].copy()), 3.0).numpy(),
        np.asarray(jmath.safe_div(jnp.asarray(x), jnp.asarray(x[::-1]), 3.0)),
        rtol=1e-6)


def _kernel_dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


@pytest.mark.parametrize("helper", ["dot3", "cross3", "safe_normalize"])
def test_vec3_helpers_round_as_the_kernels(helper):
    """core/math.py's three-vector helpers give the kernels' arithmetic
    (csrc/lane.cuh, --fmad=false) bit for bit: each product rounded, sums
    left to right, v * (1 / sqrt(|v|^2)). The replay differentiator needs
    it to trace the recording kernel's rays (ROADMAP.md, H8)."""
    r = np.random.default_rng(7)
    a = _t(r.normal(size=(4099, 3)).astype(np.float32)
           * r.uniform(0.0, 1e3, size=(4099, 1)).astype(np.float32))
    b = _t(_unit(r, 4099))
    a[:3] = torch.tensor([[0.0, -0.0, 1.0], [0.0, 1.0, 0.0], [-0.0, 0, 0]])
    if helper == "dot3":
        got, want = tmath.dot3(a, b), _kernel_dot(a, b)
    elif helper == "cross3":
        got = tmath.cross3(a, b)
        want = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)
    else:
        got = tmath.safe_normalize(a)
        n2 = _kernel_dot(a, a)[:, None]
        want = torch.where(n2 > 1e-24, a * (1.0 / torch.sqrt(n2)), a)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_bsdf_sampling_matches():
    r = np.random.default_rng(1)
    n = 256
    nl = _unit(r, n)
    d = _unit(r, n)
    u1, u2, u3 = (r.random(n).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        tbsdf.cosine_sample(_t(nl), _t(u1), _t(u2)).numpy(),
        np.asarray(jbsdf.cosine_sample(jnp.asarray(nl), jnp.asarray(u1),
                                       jnp.asarray(u2))),
        rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(
        tbsdf.mirror_dir(_t(d), _t(nl)).numpy(),
        np.asarray(jbsdf.mirror_dir(jnp.asarray(d), jnp.asarray(nl))),
        rtol=1e-6, atol=1e-7)
    flip = np.sign(np.sum(nl * d, axis=1, keepdims=True))
    nl_f = (-flip * nl).astype(np.float32)
    got = tbsdf.refr_terms(_t(d), _t(nl), _t(nl_f), 1.5)
    want = jbsdf.refr_terms(jnp.asarray(d), jnp.asarray(nl),
                            jnp.asarray(nl_f), 1.5)
    np.testing.assert_array_equal(got.tir.numpy(), np.asarray(want.tir))
    ok = ~np.asarray(want.tir)
    for name in ("tdir", "re", "tr", "p_refl"):
        np.testing.assert_allclose(getattr(got, name).numpy()[ok],
                                   np.asarray(getattr(want, name))[ok],
                                   rtol=1e-5, atol=2e-6, err_msg=name)
    albedo = r.random((n, 3)).astype(np.float32)
    depth = r.integers(0, 10, n).astype(np.int32)
    s_t, b_t = tbsdf.russian_roulette(_t(albedo), _t(depth), _t(u3), 5)
    s_j, b_j = jbsdf.russian_roulette(jnp.asarray(albedo), jnp.asarray(depth),
                                      jnp.asarray(u3), 5)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("name", ["cornell_box_scene", "procedural"])
def test_sphere_hit_t_matches(name):
    js = (jscene.procedural_sphere_scene(n=60, seed=2)
          if name == "procedural" else jscene.cornell_box_scene())
    ts = tscene.sphere_scene_from_arrays(
        np.asarray(js.center), np.asarray(js.radius),
        np.asarray(js.material.emission), np.asarray(js.material.albedo),
        np.asarray(js.material.refl))
    r = np.random.default_rng(3)
    n = 200
    org = r.uniform([10, 10, 30], [90, 70, 150], size=(n, 3)).astype(
        np.float32)
    dirs = _unit(r, n)
    eps = np.maximum(1e-4, 5e-7 * np.asarray(js.radius)).astype(np.float32)
    want_t = np.asarray(jisect.sphere_hit_t(
        jnp.asarray(org), jnp.asarray(dirs), js.center, js.radius,
        jnp.asarray(eps)))
    got_t = tisect.sphere_hit_t(_t(org), _t(dirs), ts.center, ts.radius,
                                _t(eps)).numpy()
    np.testing.assert_array_equal(np.isinf(got_t), np.isinf(want_t))
    fin = np.isfinite(want_t)
    # the two frameworks sum b = op.d in different orders; on the 1e5-radius
    # wall spheres one ulp of |op| is ~0.008, so t agrees to the f32
    # resolution of the sphere's own scale (ops/intersect.py's docstring
    # puts the stable form's error at that scale near 5e-3)
    tol = 1e-3 + 2e-6 * np.broadcast_to(np.asarray(js.radius)[None, :],
                                        want_t.shape)
    assert (np.abs(got_t[fin] - want_t[fin]) <= tol[fin]).all()


def test_weighted_accum_matches():
    r = np.random.default_rng(4)
    c1, c2 = (r.random((4, 5, 3)).astype(np.float32) for _ in range(2))
    w2 = r.integers(0, 3, (4, 5)).astype(np.float32)
    w2[0, 0] = 0.0
    j = jaccum.WeightedAccum.zeros(4, 5).add(jnp.asarray(c1))
    j = j._replace(weight=j.weight * 0).add(jnp.asarray(c2), jnp.asarray(w2))
    t = taccum.WeightedAccum.zeros(4, 5, device="cpu").add(_t(c1))
    t = t._replace(weight=t.weight * 0).add(_t(c2), _t(w2))
    np.testing.assert_array_equal(t.color.numpy(), np.asarray(j.color))
    np.testing.assert_array_equal(t.weight.numpy(), np.asarray(j.weight))
    np.testing.assert_allclose(t.normalized().numpy(),
                               np.asarray(j.normalized()), rtol=1e-6)
    np.testing.assert_allclose(
        taccum.normalize_weighted(t.color, t.weight).numpy(),
        np.asarray(jaccum.normalize_weighted(j.color, j.weight)), rtol=1e-6)


def test_render_stats_match(capsys):
    kw = dict(passes=3, rays=123456789, wall_s=0.123456)
    assert (tmetrics.RenderStats(**kw).as_dict()
            == jmetrics.RenderStats(**kw).as_dict())
    assert tmetrics.RenderStats().rays_per_s == 0.0
    tmetrics.log_json("render_pass", {"rays": 5})
    line = capsys.readouterr().err.strip()
    assert '"event": "render_pass"' in line and '"rays": 5' in line
