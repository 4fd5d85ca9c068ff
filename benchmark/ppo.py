"""The learner cell's runner: PPO across the configuration's world, a
shared policy driving every car, for a fixed time, then judged against the
plain references.

Set-up builds the world and the port's auto-reset step (``worlds.py``),
draws the start poses, the scan noise's generator and the learner's
generator from ``--seed``, resets the envs, draws the net from the
learner's generator (``PPO.init``) and runs ``warmup_iterations`` whole
iterations, so that every kernel is built, the step's CUDA graph captured
and every shape run before the window. An iteration is the port's
``PPO.train_step`` with the configuration's locality sort as its
``sort_fn``: the sort, ``rollout_steps`` graphed steps under the Gaussian
policy, then GAE and ``epochs`` x ``minibatches`` clipped updates. The
window runs whole iterations until ``seconds`` have passed (and at least
those the check and the trace need), reads nothing back, marks each
iteration's end with a CUDA event after its last launch and ends with a
synchronize.

The check follows one iteration of the window's first
``check.first_iterations``, drawn from the seed, from the program's own
state, so that float32 rounding never compounds along a chain of steps:

* env: at the rollout's first step (right after the sort) and at one plain
  step, drawn from the seed, ``race.judge`` holds the step to the step's
  reference on the sampled envs and every env done, the reset at set-up
  too, and the sort to a permutation;
* ``rollout_gap``: at those two steps the learner's reference
  (``reference.ppo``) recomputes the features, raw action, log-probability,
  value, scaled action and reward from the program's states and its policy
  noise (redrawn from a copy of the learner's generator); each quantity's
  largest gap over its RMS across the rows;
* the update, one minibatch at a time (the runner wraps ``update``,
  ``_loss_part`` and ``ts.opt.step`` of that iteration to record the
  trajectory, each minibatch's loss, gradients, and the parameters and
  Adam moments before and after; the program runs as ever): from the
  program's parameters before the minibatch, the reference's own GAE of
  the program's trajectory and the same rows (the permutations redrawn
  from the generator's copy), ``loss_gap`` (the loss's gap over the sum of
  its terms' magnitudes) and ``grad_gap`` (per leaf, the gradient's gap
  norm over the larger of the leaf's norm and the median leaf's);
  ``adam_gap``, the reference's clip and Adam from the program's own
  gradient, moments and count: the parameter change's largest gap per
  element over lr, and the moments' gaps per leaf as ``grad_gap`` (where
  the global norm lies within ``CLIP_TIE`` of the limit both branches of
  the clip are admitted); ``metric_gap``, the iteration's loss, mean
  reward and crash rate.

With ``control`` the reference in bfloat16 takes the program's place in
every check, which must then fail; ``report_control`` adds the control's
readings beside the program's (one run gives both), ``tf32`` runs the
program with TF32 matrix products. The references run after the
program's state is freed.

With ``--trace 1`` two ``torch.profiler`` stretches of one iteration each
follow the checked ones: the card's activity alone, which the per-layer
metrics read, then with the host's ops, for the breakdown. The layer
record is ``race._layer_record``'s over the iteration's ``rollout_steps``
steps, with ``ppo``: the learner's counters over the first stretch, its
spans (``span_summary`` of the first ``ppo.iteration``) and the update's
least time (``update_bound_s``).
"""

from __future__ import annotations

import dataclasses
import inspect
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import generator, roofline, worlds
from benchmark.race import (Clock, _clone, _layer_record, _leaves,
                            _profiler, _rows, _sync, judge, p95)
from benchmark.reference import ppo as ref
from benchmark.reference.step import IX_VEL, IX_YAW_RATE

CLIP_TIE = 1e-5   # global norms this near the clip's limit take either branch


# The update's least work, counted from the agent-samples that went through
# the forward and backward (the port's ``ppo.update.samples``), as K1's is
# counted from its inputs: a dense layer of n_in x n_out takes 2 n_in n_out
# flops a sample forward (its bias and activation not counted), the
# backward twice that; each sample's inputs (features, raw action, old
# log-probability, advantage, return) read once a pass. The parameters'
# and moments' traffic (under 0.1 % of it at the cell's widths) is left out,
# so the bound stays a lower one.
def update_flops(samples: int, obs_dim: int, hidden: int,
                 act_dim: int) -> int:
    forward = 2 * (obs_dim * hidden + hidden * hidden + hidden * act_dim
                   + hidden * 1)
    return 3 * forward * samples


def update_bytes(samples: int, obs_dim: int, act_dim: int) -> int:
    return roofline.F32 * samples * (obs_dim + act_dim + 3)


def update_bound_s(samples: int, obs_dim: int, hidden: int, act_dim: int):
    """(least seconds, "bytes" or "operations": which of the two binds)."""
    tb = update_bytes(samples, obs_dim, act_dim) / roofline.PEAK_BYTES_PER_S
    tf = update_flops(samples, obs_dim, hidden, act_dim) \
        / roofline.PEAK_F32_FLOPS
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _learner_module():
    """The port's learner, or a RuntimeError at once where it cannot run
    this cell (no ``sort_fn``, no counters)."""
    from f1tenth_gym_tpu_torch.parallel import ppo

    if "sort_fn" not in inspect.signature(ppo.PPO).parameters or \
            not hasattr(ppo, "COUNTERS"):
        raise RuntimeError("this port's learner takes no sort_fn or keeps "
                           "no counters: it cannot run the learner cell")
    return ppo


def ppo_config(module, cfg: dict):
    """The configuration's ``learner`` block as the port's PPOConfig."""
    lc = cfg["learner"]
    if lc["obs_dim"] != lc["obs_beams"] + 2:
        raise ValueError("obs_dim must be obs_beams + 2")
    names = {f.name for f in dataclasses.fields(module.PPOConfig)}
    return module.PPOConfig(**{k: v for k, v in lc.items() if k in names})


class Recorder:
    """The sort and step the learner drives, and its update, loss and
    optimizer step wrapped while ``armed``: what the check compares."""

    def __init__(self, sort, step, noise_gen, snap_steps):
        self.noise_gen, self.snap_steps = noise_gen, set(snap_steps)
        self.armed, self.t = False, 0
        self.snaps, self.pre, self.mb = [], None, []

        def recorded_sort(s):
            self.t = 0
            if self.armed:
                self.pre = _clone(_leaves(s))
            return sort(s)

        def recorded_step(s, a):
            keep = self.armed and self.t in self.snap_steps
            if keep:
                snap = {"t": self.t, "pre": self.pre if self.t == 0 else None,
                        "in": _clone(_leaves(s)),
                        "noise": self.noise_gen.get_state()}
            out = step(s, a)
            if keep:
                snap.update(actions=a.clone(), out=_clone(_leaves(out[0])),
                            done=out[3].clone())
                self.snaps.append(snap)
            self.t += 1
            return out

        recorded_step.generator = step.generator   # PPO's env_generator
        self.sort, self.step = recorded_sort, recorded_step

    def arm(self, ppo, ts):
        """Record the next iteration of ``ppo`` from ``ts``."""
        self.armed = True
        self.theta0 = {k: p.detach().clone()
                       for k, p in ts.net.named_parameters()}
        self.gen0 = ts.generator.get_state()
        opt, update, loss_part = ts.opt, ppo.update, ppo._loss_part

        def rec_update(ts_, traj, value_T):
            self.traj, self.value_T = traj, value_T
            return update(ts_, traj, value_T)

        def rec_loss(net, batch, mb_size):
            total, aux = loss_part(net, batch, mb_size)
            self.mb.append(dict(loss=total.detach()))
            return total, aux

        def copies(d):
            return {k: v.detach().clone() for k, v in d.items()}

        def rec_opt_step():
            m = self.mb[-1]
            m.update(count=int(opt.count), mu=copies(opt.mu),
                     nu=copies(opt.nu), before=copies(opt.params),
                     grad={k: p.grad.detach().clone()
                           for k, p in opt.params.items()})
            step_fn()
            m.update(after=copies(opt.params), mu2=copies(opt.mu),
                     nu2=copies(opt.nu))

        step_fn = opt.step
        ppo.update, ppo._loss_part, opt.step = rec_update, rec_loss, \
            rec_opt_step
        self._restore = (ppo, opt)

    def disarm(self):
        ppo, opt = self._restore
        del ppo.update, ppo._loss_part, opt.step
        self.armed = False


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False, report_control: bool = False,
        tf32: bool = False) -> dict:
    """One run of a learner cell: the result's fields (``race.run``'s).
    ``control``, ``report_control`` and ``tf32`` (module docstring) are for
    the benchmark's tests and its calibration."""
    module = _learner_module()
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.utils import profiling

    cfg, tr = cell["config"], cell["traffic"]
    dev = torch.device(device)
    s_pose, s_noise, s_check, s_learn = generator.seeds(seed)
    rng = np.random.default_rng(s_check)
    E, A = int(tr["envs"]), int(cfg["num_agents"])
    pcfg = ppo_config(module, cfg)
    T = pcfg.rollout_steps

    world = worlds.build(cfg, dev)
    noise_gen = generator.generator(dev, s_noise)
    sim, params, tables, step = worlds.system(cfg, world, dev, noise_gen)
    poses = world.sampler(generator.generator(dev, s_pose), (E, A))
    start_rows = torch.as_tensor(
        np.sort(rng.choice(E, min(E, tr["check"]["sample_envs"]),
                           replace=False)), device=dev)
    noise0 = noise_gen.get_state()
    s, *_ = P.batch_reset(poses, params, world.map_data, tables, sim,
                          cfg["timestep"], generator=noise_gen, device=dev)
    start = dict(rows=start_rows, poses=poses[start_rows].clone(),
                 noise=noise0, state=_clone(_rows(_leaves(s), start_rows)))
    first = int(tr["check"]["first_iterations"])
    check_at = int(rng.integers(first))
    rec = Recorder(world.sort, step, noise_gen, (0, int(rng.integers(1, T))))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    ppo = module.PPO(params, world.map_data, tables, sim, cfg["timestep"],
                     pcfg, step_fn=rec.step, device=dev, sort_fn=rec.sort)
    ts = ppo.init(s, generator.generator(dev, s_learn))
    del s
    for _ in range(int(tr["warmup_iterations"])):
        ts, _ = ppo.train_step(ts)
    _sync(dev)
    setup_s = time.time() - t_start

    # two profiled iterations after the checked ones: the card's activity
    # alone, which the per-layer metrics read, then the host's ops beside it
    plan = {first: "device", first + 1: "host"} if trace else {}
    min_iters = first + 2 * trace
    clock, stretches, counts = Clock(dev), {}, {}
    i, metrics = 0, None
    t0 = time.perf_counter()
    clock.mark()
    while i < min_iters or time.perf_counter() - t0 < seconds:
        prof = None
        if i in plan:
            _sync(dev)
            if plan[i] == "device":
                profiling.clear_spans()
                counts = dict(module.COUNTERS)
            prof = _profiler(dev, host=plan[i] == "host")
            prof.start()
            ta = time.perf_counter()
        if i == check_at:
            rec.arm(ppo, ts)
        ts, m = ppo.train_step(ts)
        if i == check_at:
            rec.disarm()
            metrics = m
        clock.mark()
        i += 1
        if prof is not None:
            _sync(dev)
            stretches[plan[i - 1]] = (prof, time.perf_counter() - ta)
            prof.stop()
            if plan[i - 1] == "device":
                counts = {k: v - counts[k] for k, v in
                          module.COUNTERS.items()}
    _sync(dev)
    elapsed = time.perf_counter() - t0
    gaps = clock.gaps_ms()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    segments = world.map_data.segments.cpu().numpy()
    layer = None
    if stretches:
        layer = _layer_record(stretches, T, E * A, int(cfg["num_beams"]),
                              segments)
        lc = cfg["learner"]
        bound_s, bound_by = update_bound_s(
            counts["ppo.update.samples"], lc["obs_dim"], lc["hidden"],
            lc["act_dim"])
        layer["ppo"] = dict(counters=counts,
                            spans=profiling.span_summary("ppo.iteration", 1),
                            update_bound_s=bound_s, update_bound_by=bound_by)
    # the program's state goes before the references run
    del ts, ppo, step
    world.map_data = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    verdict = judge(cfg, tr, world, segments, start, rec.snaps, E, dev, rng,
                    control)
    lim = tr["limits"]
    got = learner_readings(cfg, rec, metrics, E, dev, lim, control)
    checks = dict(verdict["checks"],
                  **{k: (v, lim[k]) for k, v in got["gaps"].items()})
    out = dict(
        attempted=i * T * E, failed=verdict["failed"] + got["failed"],
        judged=verdict["judged"] + got["judged"], checks=checks,
        memory_peak_bytes=int(peak),
        end_to_end=dict(env_steps_per_s=i * T * E / elapsed,
                        step_ms_p95=p95(gaps), setup_s=setup_s),
        layer=layer,
        note=(f"iterations={i} envs={E} steps_per_iteration={T} "
              f"window_s={elapsed:.3f} setup_s={setup_s:.3f} "
              f"rate={i * T * E / elapsed:.1f} p95_ms={p95(gaps):.3f} "
              f"median_iteration_ms={float(np.median(gaps)):.3f} "
              f"checked_iteration={check_at} "
              f"snap_steps={sorted(rec.snap_steps)} "
              f"clip_ties={got['clip_ties']} parts={got['parts']}"))
    if report_control and not control:
        out["control_checks"] = learner_readings(cfg, rec, metrics, E, dev,
                                                 lim, True)["gaps"]
    return out


def _rel(a, b, scale) -> float:
    """max |a - b| / scale, in float64; NaN reads as infinity."""
    d = (a.double() - b.double()).abs().max()
    return float(torch.nan_to_num(d / scale, nan=float("inf")))


def _rms(x) -> torch.Tensor:
    x = x.double()
    return torch.sqrt((x * x).mean()).clamp_min(1e-30)


def _leaf_gaps(got: dict, want: dict) -> float:
    """Per leaf ||got - want|| over the larger of ||want|| and the median
    leaf's ||want||: the largest."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double()))
             for k in ref.LEAVES}
    floor = statistics.median(norms.values())
    out = 0.0
    for k in ref.LEAVES:
        d = float(torch.linalg.vector_norm(got[k].double()
                                           - want[k].double()))
        out = max(out, d / max(norms[k], floor, 1e-30))
    return out if np.isfinite(out) else float("inf")


def _replay_draws(gen_state, E: int, A: int, T: int, pcfg, dev, dtype):
    """The learner generator's draws of one iteration from ``gen_state``:
    the T policy-noise tensors (E, A, 2), then one permutation an epoch."""
    g = torch.Generator(device=dev)
    g.set_state(gen_state)
    noise = [torch.randn((E, A, 2), generator=g, dtype=dtype, device=dev)
             for _ in range(T)]
    perms = [torch.randperm(T * E, generator=g, device=dev)
             for _ in range(pcfg.epochs)]
    return noise, perms


def learner_readings(cfg: dict, rec: Recorder, metrics: dict, E: int, dev,
                     lim: dict, control: bool) -> dict:
    """The learner's gaps (module docstring) of the program's recorded
    iteration, or of the reference in bfloat16 in its place (``control``),
    against the reference in float64; ``failed``: the rows, minibatches and
    metrics over the limits ``lim``."""
    lc, vp = cfg["learner"], cfg["vehicle_params"]
    A = int(cfg["num_agents"])
    traj = rec.traj
    T = traj["reward"].shape[0]
    pc = SimpleNamespace(**lc)
    low = torch.bfloat16
    f64 = torch.float64
    steer_lim = max(abs(vp["s_min"]), abs(vp["s_max"]))
    noise, perms = _replay_draws(rec.gen0, E, A, T, pc, dev,
                                 traj["raw"].dtype)

    # -- the rollout at the snapshot steps
    def rollout(snap, dtype):
        s_in, s_out = snap["in"], snap["out"]
        p = ref.cast(rec.theta0, dtype)
        x = s_in["x"].to(dtype)
        feats = ref.featurize(s_in["scans"].to(dtype), x[..., IX_VEL],
                              x[..., IX_YAW_RATE], lc["obs_beams"],
                              cfg["max_range"])
        raw, logp, value = ref.policy(p, feats, noise[snap["t"]].to(dtype))
        return dict(
            feats=feats, raw=raw, logp=logp, value=value,
            actions=ref.scale_actions(raw, steer_lim, vp["v_max"]),
            reward=ref.shaped_reward(
                s_out["x"][..., IX_VEL].to(dtype),
                s_out["collisions"].to(dtype), cfg["timestep"],
                lc["speed_reward"], lc["crash_penalty"]))

    roll_gap, parts = 0.0, {}
    roll_rows = []
    for snap in rec.snaps:
        want = rollout(snap, f64)
        if control:
            got = rollout(snap, low)
        else:
            t = snap["t"]
            got = {k: traj[k][t] for k in ("feats", "raw", "logp", "value",
                                           "reward")}
            got["actions"] = snap["actions"]
        for k, w in want.items():
            g = got[k].double()
            rms = _rms(w)
            gap = _rel(g, w, rms)
            parts[f"rollout.{k}"] = max(parts.get(f"rollout.{k}", 0.0), gap)
            roll_gap = max(roll_gap, gap)
            d = torch.nan_to_num((g - w).abs() / rms, nan=float("inf"))
            roll_rows.append(d.reshape(d.shape[0], -1).amax(-1))
    roll_rows = torch.cat(roll_rows) if roll_rows else torch.zeros(0)

    # -- the update, teacher-forced a minibatch at a time
    def advantages(dtype):
        advs, rets = ref.gae(traj["value"].to(dtype),
                             traj["reward"].to(dtype), traj["done"],
                             rec.value_T.to(dtype), pc.gamma, pc.gae_lambda)
        return ref.normalize(advs).reshape(T * E, A), rets.reshape(T * E, A)

    def flat(dtype, adv, ret):
        return dict(feats=traj["feats"].reshape(T * E, A, -1).to(dtype),
                    raw=traj["raw"].reshape(T * E, A, -1).to(dtype),
                    logp=traj["logp"].reshape(T * E, A).to(dtype),
                    adv=adv, ret=ret)

    want_flat = flat(f64, *advantages(f64))
    low_flat = flat(low, *advantages(low)) if control else None
    mb_size = T * E // pc.minibatches
    loss_gap = grad_gap = adam_gap = 0.0
    clip_ties = 0
    mb_failed = 0
    losses_want, losses_low, scale_sum = [], [], 0.0
    for k, m in enumerate(rec.mb):
        perm = perms[k // pc.minibatches]
        take = perm[(k % pc.minibatches) * mb_size:
                    (k % pc.minibatches + 1) * mb_size]
        coefs = (pc.clip_eps, pc.vf_coef, pc.ent_coef)
        total, terms, grads = ref.loss_and_grad(
            ref.cast(m["before"]), {n: v[take] for n, v in
                                    want_flat.items()}, *coefs)
        scale = float(terms["pg"].abs() + pc.vf_coef * terms["vf"].abs()
                      + pc.ent_coef * terms["ent"].abs())
        losses_want.append(float(total))
        scale_sum += scale
        # the reference's clip and Adam from the program's own gradient,
        # moments and count
        g64 = ref.cast(m["grad"])
        mu64, nu64 = ref.cast(m["mu"]), ref.cast(m["nu"])
        norm = float(ref.global_norm(g64))
        branches = [None]
        if abs(norm - pc.max_grad_norm) < CLIP_TIE:
            branches, clip_ties = [True, False], clip_ties + 1
        adam_want = [ref.clipped_adam(g64, mu64, nu64, m["count"], pc.lr,
                                      pc.max_grad_norm, pc.adam_b1,
                                      pc.adam_b2, pc.adam_eps, clip=b)
                     for b in branches]
        if control:
            g_total, _, g_grads = ref.loss_and_grad(
                ref.cast(m["before"], low),
                {n: v[take] for n, v in low_flat.items()}, *coefs)
            theta = ref.cast(m["before"], low)
            ch, mu2, nu2, _ = ref.clipped_adam(
                ref.cast(m["grad"], low), ref.cast(m["mu"], low),
                ref.cast(m["nu"], low), m["count"], pc.lr, pc.max_grad_norm,
                pc.adam_b1, pc.adam_b2, pc.adam_eps)
            losses_low.append(float(g_total))
            change = {n: (theta[n] + ch[n]).double() - theta[n].double()
                      for n in ref.LEAVES}
        else:
            g_total, g_grads = m["loss"], m["grad"]
            change = {n: m["after"][n].double() - m["before"][n].double()
                      for n in ref.LEAVES}
            mu2, nu2 = m["mu2"], m["nu2"]
        lg = abs(float(g_total) - float(total)) / max(scale, 1e-30)
        gg = _leaf_gaps(g_grads, grads)
        ag = min(max(max(_rel(change[n], w[0][n], pc.lr)
                         for n in ref.LEAVES),
                     _leaf_gaps(mu2, w[1]), _leaf_gaps(nu2, w[2]))
                 for w in adam_want)
        loss_gap, grad_gap = max(loss_gap, lg), max(grad_gap, gg)
        adam_gap = max(adam_gap, ag)
        mb_failed += (lg > lim["loss_gap"] or gg > lim["grad_gap"]
                      or ag > lim["adam_gap"])

    # -- the iteration's metrics
    reward64 = traj["reward"].double()
    crash64 = traj["done"].double().mean()
    loss64 = float(np.mean(losses_want))
    if control:
        r_low = traj["reward"].to(low)
        got_m = dict(loss=float(np.mean(losses_low)),
                     mean_reward=float(r_low.mean()),
                     crash_rate=float(traj["done"].to(low).mean()))
    else:
        got_m = {k: float(v) for k, v in metrics.items()}
    metric_gap = max(
        abs(got_m["loss"] - loss64) / max(scale_sum / len(rec.mb), 1e-30),
        abs(got_m["mean_reward"] - float(reward64.mean()))
        / max(float(reward64.abs().mean()), 1e-30),
        abs(got_m["crash_rate"] - float(crash64))
        / max(float(crash64), 1.0 / traj["done"].numel()))
    gaps = dict(rollout_gap=roll_gap, loss_gap=loss_gap, grad_gap=grad_gap,
                adam_gap=adam_gap, metric_gap=metric_gap)
    failed = (int((roll_rows > lim["rollout_gap"]).sum()) + mb_failed
              + int(metric_gap > lim["metric_gap"]))
    return dict(gaps=gaps, failed=failed, clip_ties=clip_ties,
                parts={k: float(f"{v:.3g}") for k, v in parts.items()},
                judged=int(roll_rows.numel()) + len(rec.mb) + 1)
