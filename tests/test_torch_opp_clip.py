"""PyTorch port: the racing step's opponent clip (ops/opp_clip_kernel.py).

K3, the CUDA kernel, runs only on the card. Here the plain version, which
is ``ray_cast_opponents`` as the step ran it before K3, is held to the JAX
package's ``ray_cast_opponents`` over the fuzz ensemble of
``ops/opp_clip_fuzz.py``, and a plain transcription of K3's loop order
(the per-scan prologue into per-(opponent, edge) constants, the edge tests
only for beams inside a window, every other beam passed through) is held
bit for bit to the plain version over the same ensemble, which
``chip_smoke.py`` also runs K3 on.

The card tests (marker ``card``) hold K3 itself to the plain version and
skip without CUDA. The card's machine has no JAX, which this folder's
conftest imports, so there they run without it:
``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_opp_clip.py -m card``.
"""

import numpy as np
import pytest
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.core import simulator as sim_mod
from f1tenth_gym_tpu_torch.maps import map_path
from f1tenth_gym_tpu_torch.ops import collision as col_ops
from f1tenth_gym_tpu_torch.ops import opp_clip_kernel as oc
from f1tenth_gym_tpu_torch.ops.opp_clip_fuzz import (
    fuzz_opp_clip_inputs,
    opp_clip_tables,
    same_bits,
)
from f1tenth_gym_tpu_torch.state import IX_X, IX_Y, IX_YAW

NB = 108
ENVS = 240
needs_card = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA card; this machine has "
                                "none")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _nan_min(a, b):
    """K3's amin step (torch's): NaN wins."""
    return torch.where(torch.isnan(a) | (a < b), a, b)


def k3_transcription(x, scans, vertices, tables):
    """K3's computation in K3's order, in torch ops: (clipped scans,
    counts of the cases it met). The transcendental functions run on
    tensors of the plain version's shapes, so that they give its bits."""
    dt = scans.dtype
    inf = torch.tensor(float("inf"), dtype=dt)
    B, A = scans.shape[-1], scans.shape[-2]
    O = A - 1
    sc = scans.reshape(-1, B)
    n = sc.shape[0]
    xx = x.reshape(n, -1)
    angles = tables.scan_angles

    # the opponents of scan i: the other agents of its env, ascending
    i = torch.arange(n)
    a = i % A
    o = torch.arange(O)
    opp = vertices.reshape(n, 4, 2)[(i - a)[:, None] + o[None]
                                    + (o[None] >= a[:, None])]  # (n, O, 4, 2)

    # ---- 1. prologue: per (scan, opponent, vertex), and per scan
    ox, oy, th = xx[:, IX_X], xx[:, IX_Y], xx[:, IX_YAW]
    st, ct = torch.sin(th), torch.cos(th)
    ego = torch.atan2(st, ct)[:, None, None]
    va = opp
    vb = torch.roll(opp, -1, dims=-2)
    vang = torch.atan2(va[..., 1] - oy[:, None, None],
                       va[..., 0] - ox[:, None, None])
    diff = ego - vang
    diff = torch.where(diff > np.pi, diff - 2 * np.pi, diff)
    diff = torch.where(diff < -np.pi, diff + 2 * np.pi, diff)
    a0, inc = angles[0], angles[1] - angles[0]
    bins = (-diff - a0) / inc - 0.5
    ind = torch.clamp(torch.ceil(bins), 0, B - 1)
    lo = ind[..., 0]
    hi = ind[..., 0]
    for k in (1, 2, 3):
        lo = _nan_min(lo, ind[..., k])
        hi = torch.where(torch.isnan(hi) | (hi > ind[..., k]), hi,
                         ind[..., k])
    v1x = ox[:, None, None] - va[..., 0]
    v1y = oy[:, None, None] - va[..., 1]
    v2x = vb[..., 0] - va[..., 0]
    v2y = vb[..., 1] - va[..., 1]
    cross = v2x * v1y - v2y * v1x
    col = torch.minimum(
        torch.sqrt(v1x * v1x + v1y * v1y),
        torch.sqrt((vb[..., 0] - ox[:, None, None]) ** 2
                   + (vb[..., 1] - oy[:, None, None]) ** 2))
    fallback = torch.where(torch.abs(cross) < 1e-8, col, inf)  # (n, O, 4)

    # ---- 2. the edge tests, for (scan, opponent, beam) inside a window
    beam = torch.arange(B, dtype=dt)
    in_win = (beam >= lo[..., None]) & (beam <= hi[..., None])  # (n, O, B)
    s, q, b = torch.nonzero(in_win, as_tuple=True)
    ca = torch.cos(angles + np.pi / 2.0)[b]
    sa = torch.sin(angles + np.pi / 2.0)[b]
    v3x = ct[s] * ca - st[s] * sa
    v3y = st[s] * ca + ct[s] * sa
    near = torch.full_like(v3x, float("inf"))
    zero_col = zero_far = 0
    for e in range(4):
        denom = v2x[s, q, e] * v3x + v2y[s, q, e] * v3y
        d1 = cross[s, q, e] / denom
        d2 = (v1x[s, q, e] * v3x + v1y[s, q, e] * v3y) / denom
        valid = (torch.abs(denom) > 0) & (d1 >= 0) & (d2 >= 0) & (d2 <= 1)
        flat = torch.abs(denom) <= 0
        dist = torch.where(flat, fallback[s, q, e],
                           torch.where(valid, d1, inf))
        near = _nan_min(near, dist)
        zero_col += int((flat & torch.isfinite(fallback[s, q, e])).sum())
        zero_far += int((flat & ~torch.isfinite(fallback[s, q, e])).sum())
    best = torch.full((n, O, B), float("inf"), dtype=dt)
    best[s, q, b] = near
    closest = best[:, 0]
    for k in range(1, O):
        closest = _nan_min(closest, best[:, k])
    touched = in_win.any(1)
    out = torch.where(touched, torch.minimum(sc, closest), sc)

    ties = bins == torch.floor(bins)
    stats = dict(
        window_pairs=int(in_win.sum()), denom_zero_fallback=zero_col,
        denom_zero_no_fallback=zero_far,
        tie_at_lo=int((ties & (ind == lo[..., None])).sum()),
        tie_at_hi=int((ties & (ind == hi[..., None])).sum()),
        whole_scan_windows=int(((lo == 0) & (hi == B - 1)).sum()),
        nan_in_window=int((touched & torch.isnan(sc)).sum()),
        inf_in_window=int((touched & torch.isinf(sc)).sum()))
    return out.reshape(scans.shape), stats


def _inputs(agents, dtype, exact=True, envs=ENVS, seed=0):
    tables = (opp_clip_tables(NB, dtype, "cpu") if exact else
              P.make_scan_tables(num_beams=NB, dtype=dtype, device="cpu"))
    return fuzz_opp_clip_inputs(envs, agents, tables, seed=seed) + (tables,)


@pytest.mark.parametrize("agents", [2, 3, 4])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "default"])
def test_plain_matches_jax(agents, exact):
    """The plain clip against the JAX package's ``ray_cast_opponents``
    (vmapped over envs and agents, the same opponents gathered) on the
    float64 fuzz, whose special cases (collinear edges with and without
    the fallback, half-bin ties, whole-scan windows, inf and NaN in
    windows) no other cross-package test reaches."""
    import jax
    import jax.numpy as jnp

    from f1tenth_gym_tpu.ops import collision as jcol

    x, scans, verts, tables = _inputs(agents, torch.float64, exact,
                                      seed=10 + agents)
    _, stats = k3_transcription(x, scans, verts, tables)
    cases = [k for k, v in stats.items() if v > 0]
    want_cases = ["window_pairs", "denom_zero_fallback",
                  "denom_zero_no_fallback", "whole_scan_windows",
                  "nan_in_window", "inf_in_window"]
    if exact:
        want_cases += ["tie_at_lo", "tie_at_hi"]
    assert set(want_cases) <= set(cases), stats

    got = oc.opp_clip_plain(x, scans, verts, tables).numpy()
    k = np.arange(agents - 1)
    opp_idx = k + (k >= np.arange(agents)[:, None])
    poses = x[..., [IX_X, IX_Y, IX_YAW]].numpy()
    jt = type("Tables", (), {})()
    jt.scan_angles = jnp.asarray(tables.scan_angles.numpy())
    want = np.asarray(jax.vmap(jax.vmap(
        lambda p, sc, ov: jcol.ray_cast_opponents(p, sc, ov, jt)))(
        jnp.asarray(poses), jnp.asarray(scans.numpy()),
        jnp.asarray(verts.numpy()[:, opp_idx])))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert (got != scans.numpy()).sum() > 100   # the pass fires


@pytest.mark.parametrize("agents", [2, 3, 4])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "default"])
def test_transcription_matches_plain(agents, exact):
    x, scans, verts, tables = _inputs(agents, torch.float32, exact,
                                      seed=agents)
    want = oc.opp_clip_plain(x, scans, verts, tables)
    got, stats = k3_transcription(x, scans, verts, tables)
    assert stats["window_pairs"] > 0
    assert same_bits(got, want)
    assert not same_bits(want, scans)   # some beam was clipped


def test_transcription_matches_plain_float64():
    x, scans, verts, tables = _inputs(3, torch.float64, seed=5)
    got, _ = k3_transcription(x, scans, verts, tables)
    assert same_bits(got, oc.opp_clip_plain(x, scans, verts, tables))


def test_fuzz_meets_every_case():
    """The ensemble reaches each case K3 treats apart: exactly collinear
    edges with and without the fallback, half-bin ties at both ends of a
    window, windows over the whole scan, inf and NaN scans in windows."""
    x, scans, verts, tables = _inputs(2, torch.float32)
    _, stats = k3_transcription(x, scans, verts, tables)
    for key, count in stats.items():
        assert count > 0, (key, stats)


def test_leading_axes():
    """Any leading batch axes: (2, E/2, A, ...) gives the (E, A, ...)
    result's bits, in the plain version and in the transcription."""
    x, scans, verts, tables = _inputs(3, torch.float32, seed=7)
    flat = oc.opp_clip_plain(x, scans, verts, tables)

    def split(t):
        return t.reshape(2, ENVS // 2, *t.shape[1:])

    got = oc.opp_clip(split(x), split(scans), split(verts), tables)
    assert got.shape == (2, ENVS // 2, 3, NB)
    assert same_bits(got.reshape(flat.shape), flat)
    tr, _ = k3_transcription(split(x), split(scans), split(verts), tables)
    assert same_bits(tr.reshape(flat.shape), flat)


@pytest.mark.parametrize("agents", [2, 3])
def test_sim_step_on_cpu_keeps_its_bits(monkeypatch, agents):
    """On the CPU the step clips through ``opp_clip`` with no launch, and
    its scans are what the step's former code gives on the same inputs:
    the post-zeroing poses, the opponents gathered in ascending order and
    ``ray_cast_opponents``."""
    m = P.load_map(map_path("example_map"), device="cpu")
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    params = P.VehicleParams.create(device="cpu")
    cfg = P.SimConfig(num_agents=agents, num_beams=NB, scan_engine="march")
    rng = np.random.default_rng(agents)
    E = 6
    poses = np.zeros((E, agents, 3))
    poses[..., 0] = 0.7 + rng.uniform(-0.5, 0.5, (E, agents))
    poses[..., 1] = rng.uniform(-2.0, 0.0, (E, agents))
    poses[..., 2] = 1.3708 + rng.uniform(-0.3, 0.3, (E, agents))
    gen = P.make_generator("cpu", 3)
    state, *_ = P.batch_reset(torch.as_tensor(poses, dtype=torch.float32),
                              params, m, tables, cfg, 0.01, generator=gen,
                              device="cpu")
    calls = []
    real = oc.opp_clip

    def recording(x, scans, vertices, t):
        out = real(x, scans, vertices, t)
        calls.append((x.clone(), scans.clone(), vertices.clone(), out))
        return out

    monkeypatch.setattr(oc, "opp_clip", recording)
    oc.opp_clip.launches = 0
    actions = torch.tensor([[0.1, 3.0]] * agents).expand(E, agents, 2)
    for _ in range(3):
        state, *_ = P.batch_step(state, actions, params, m, tables, cfg,
                                 0.01, gen)
    assert real.launches == 0
    assert len(calls) == 3
    for x, scans, vertices, out in calls:
        poses_post = torch.stack([x[..., IX_X], x[..., IX_Y],
                                  x[..., IX_YAW]], -1)
        k = torch.arange(agents - 1)
        opp_idx = k + (k >= torch.arange(agents)[:, None])
        want = col_ops.ray_cast_opponents(poses_post, scans,
                                          vertices[..., opp_idx, :, :],
                                          tables)
        assert same_bits(out, want)
    assert same_bits(calls[-1][3], state.scans)
    assert sim_mod.opp_clip_kernel is oc


def test_input_checks():
    x, scans, verts, tables = _inputs(2, torch.float32, envs=4)
    ok = oc.opp_clip(x, scans, verts, tables)
    assert ok.shape == scans.shape
    bad = [
        (x.double(), scans, verts, tables),
        (x, scans, verts.transpose(-1, -2).contiguous().transpose(-1, -2),
         tables),
        (x[:, :1], scans[:, :1], verts[:, :1], tables),
        (x, scans[..., :-1], verts, tables),
        (x[..., :3], scans, verts, tables),
        (x, scans.to(torch.int32), verts, tables),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            oc.opp_clip(*args)


# --------------------------------------------------------------------------
# the card: K3 itself
# --------------------------------------------------------------------------

@pytest.mark.card
@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("agents", [2, 4])
def test_k3_matches_plain_on_card(dtype, agents):
    card = torch.device("cuda:0")
    for beams, exact in ((1080, True), (1080, False), (108, True),
                         (1081, True)):
        tables = (opp_clip_tables(beams, dtype, card) if exact else
                  P.make_scan_tables(num_beams=beams, dtype=dtype,
                                     device=card))
        x, scans, verts = fuzz_opp_clip_inputs(2048, agents, tables,
                                               seed=agents)
        before = oc.opp_clip.launches
        got = oc.opp_clip(x, scans, verts, tables)
        torch.cuda.synchronize()
        assert oc.opp_clip.launches == before + 1
        want = oc.opp_clip_plain(x, scans, verts, tables)
        assert same_bits(got, want), (beams, exact)


@pytest.mark.card
@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("agents", [18, 40, 64])
def test_k3_many_agents_on_card(dtype, agents):
    """More opponents than one chunk of K3's shared memory holds (16):
    the chunks clip each scan in turn, and the bits are the plain
    clip's. A few envs, since the plain clip's broadcast grows as A^2."""
    card = torch.device("cuda:0")
    tables = opp_clip_tables(1080, dtype, card)
    x, scans, verts = fuzz_opp_clip_inputs(8, agents, tables, seed=agents)
    got = oc.opp_clip(x, scans, verts, tables)
    torch.cuda.synchronize()
    want = oc.opp_clip_plain(x, scans, verts, tables)
    assert same_bits(got, want)
    assert not same_bits(got, scans)


@pytest.mark.card
@needs_card
def test_sim_step_on_card_launches_k3_once():
    card = torch.device("cuda:0")
    m = P.load_map(map_path("example_map"), device=card)
    tables = P.make_scan_tables(num_beams=1080, device=card)
    params = P.VehicleParams.create(device=card)
    cfg = P.SimConfig(num_agents=2, num_beams=1080, scan_engine="march")
    poses = torch.tensor([[[0.7, 0.0, 1.3708], [0.7, -1.0, 1.3708]]] * 8,
                         device=card)
    gen = P.make_generator(card, 3)
    state, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                              generator=gen, device=card)
    oc.opp_clip.launches = 0
    actions = torch.tensor([[0.0, 3.0]] * 2, device=card).expand(8, 2, 2)
    for _ in range(4):
        state, *_ = P.batch_step(state, actions, params, m, tables, cfg,
                                 0.01, gen)
    torch.cuda.synchronize()
    assert oc.opp_clip.launches == 4
