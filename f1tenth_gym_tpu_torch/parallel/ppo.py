"""PPO learner over a batch of envs, on one device or over a mesh of ranks.

Port of ``f1tenth_gym_tpu/parallel/ppo.py``: the same ``PPOConfig``, the
same actor-critic MLP, per-agent rewards, values and GAE (a crashing
opponent never pollutes the ego's gradient), multi-epoch minibatch
updates, entropy bonus and advantage normalization. The JAX package jits
the whole iteration into one program over a mesh; here it is eager torch,
one rank a device.

``PPO(mesh=...)`` (a mesh of ``parallel/sharding.py``) gives the results
of one process on the full batch, up to the order of the reductions:

* rollout: each rank steps its shard of the envs. The policy noise is
  drawn for the global (E, A, 2) shape from the learner's generator,
  which every rank seeds alike, and each rank takes its rows. The step's
  own generator (the scan noise) is per rank, seeded from
  ``DEFAULT_SEED`` plus the rank's 'env' index, so the sharded scan noise
  parts from the one-process stream (at world size 1 it is that stream);
* advantages are normalised with the global mean and population std
  (``all_reduce``);
* each epoch draws the global permutation of the T * E_global samples;
  each rank takes the samples of each minibatch that it owns (flat index
  ``t * E + e``, owner ``e // E_local``) and backpropagates the sum of
  their loss terms over the global minibatch size. The entropy term, which
  depends only on ``pi_log_std``, is weighted by the rank's share of the
  rows, so that the ranks' sum counts it once;
* the gradients are summed over 'env' inside the backward pass, in the
  compute dtype before the cast to the float32 parameters, so one
  rounding to float32 remains, as in one process;
* ``ClippedAdam``'s global-norm clip and Adam then run alike on every
  rank; the metrics are global means;
* over 'model' the MLP is split as JAX ``_shard_net_params`` splits it
  (``:173-197``): ``fc1`` by output, ``fc2`` by input (Megatron's
  column/row split), with ``fc2``'s partial products summed over 'model'
  before its bias and tanh. ``fc1``'s bias is split with its kernel (the
  JAX package keeps it whole; the sums are the same). The full weights
  are drawn on every rank and then sliced, so ``init`` equals the
  unsharded ``init``; the clip sums the split parameters' squared norms
  over 'model' and counts the others once.

At world size 1 no collective runs and every result is the unsharded
learner's, bit for bit.

Where the port follows flax and optax rather than torch's defaults:

* ``ActorCritic`` keeps its ``Dense`` weights and biases in float32 (flax's
  default ``param_dtype``) and computes in the input's dtype; its
  ``pi_log_std`` is in the sim dtype. A float64 input therefore meets
  float32 weights cast up, and autograd casts their gradients back down.
* The kernels are drawn as flax's ``lecun_normal``: fan-in variance
  scaling, a normal truncated at +-2 sigma with sigma =
  sqrt(1/fan_in)/0.87962566103423978; biases are zero, ``pi_log_std``
  -0.5. Every draw comes from an explicit ``torch.Generator``.
* ``ClippedAdam`` is ``optax.chain(clip_by_global_norm, adam)``: the
  gradients are left alone when their global norm is below the limit and
  scaled by limit/norm otherwise (``clip_grad_norm_`` divides by norm +
  1e-6 instead), then Adam with eps outside the square root.
* Advantages are normalized by the population std (``jnp.std``, ddof 0).

The policy noise and the minibatch permutations come from the learner's
generator (``TrainState.generator``); the env's scan noise from the step's
own generator: ``make_autoreset_step``'s, or one that ``PPO`` owns when no
``step_fn`` is given. ``TrainState.env_generator`` is that generator, so
that a checkpoint of the ``TrainState`` resumes bit for bit.

``PPO(sort_fn=...)`` (states -> states, e.g. a locality sort) relabels the
envs before each rollout, so that the scan kernel's subgroups share a
culling window through the rollout; under a mesh each rank sorts its own
rows. It draws nothing from either generator, and without it every result
is the unsorted learner's, bit for bit.

Spans (``utils/profiling.annotate``; off unless a profiler records):
``ppo.iteration`` (top level, around ``train_step``) > ``ppo.sort``,
``ppo.rollout`` > ``ppo.policy`` (featurize, forward, sample and scale: one
a rollout step), then ``ppo.update`` > ``ppo.gae``, ``ppo.minibatch``
(forward and backward), ``ppo.adam`` (``ClippedAdam.step``).
``ppo.iteration``, ``ppo.rollout`` and ``ppo.update`` record their extent
on the card. ``COUNTERS`` counts on the host: ``ppo.iterations``,
``ppo.rollout.steps`` and ``ppo.update.samples`` (the rank's agent-samples
through the forward and backward, summed over the epochs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from f1tenth_gym_tpu_torch.config import DEFAULT_SEED, SimConfig, resolve_device
from f1tenth_gym_tpu_torch.parallel.sharding import (
    ENV_AXIS,
    MODEL_AXIS,
    all_reduce_sum,
    axis_group,
    env_shard,
    local_device,
)
from f1tenth_gym_tpu_torch.parallel.vector import batch_step, make_generator
from f1tenth_gym_tpu_torch.state import MapData, ScanTables, SimState, VehicleParams
from f1tenth_gym_tpu_torch.utils.profiling import annotate

# flax's variance_scaling(..., "truncated_normal"): the std of a unit
# normal truncated at +-2
_TRUNC_STD = 0.87962566103423978
_LOG_2PI = math.log(2.0 * np.pi)

# the learner's counters (module docstring): host ints, never a sync
COUNTERS = {"ppo.iterations": 0, "ppo.rollout.steps": 0,
            "ppo.update.samples": 0}


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    obs_beams: int = 64          # scan downsample size fed to the net
    hidden: int = 256
    rollout_steps: int = 32
    epochs: int = 4
    minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    # reward shaping: progress (speed) minus crash penalty
    speed_reward: float = 1.0
    crash_penalty: float = 10.0


class _SumOverModel(torch.autograd.Function):
    """Megatron's row-parallel reduction: the forward sums the partial
    products over the 'model' group; the backward passes the gradient on,
    since every rank holds the same gradient of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GradSumOverEnv(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the 'env'
    group: applied to a parameter where the forward uses it, it reduces
    that parameter's gradient in the compute dtype."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


def _used(p: torch.Tensor, dtype, env_group) -> torch.Tensor:
    """Parameter ``p`` as the forward uses it: in ``dtype``, its gradient
    summed over ``env_group`` (when there is one) before the cast back."""
    p = p.to(dtype)
    return p if env_group is None else _GradSumOverEnv.apply(p, env_group)


class _Dense(nn.Module):
    """flax ``nn.Dense``: float32 parameters, computed in the input's
    dtype. ``weight`` is (out, in), the transpose of flax's kernel.
    ``env_group`` is set by ``ActorCritic.shard``."""

    env_group = None

    def __init__(self, n_in: int, n_out: int, dev: torch.device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((n_out, n_in),
                                               dtype=torch.float32, device=dev))
        self.bias = nn.Parameter(torch.zeros((n_out,), dtype=torch.float32,
                                             device=dev))

    def reset_parameters(self, generator: torch.Generator):
        std = math.sqrt(1.0 / self.weight.shape[1]) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2.0 * std,
                                  b=2.0 * std, generator=generator)
            self.bias.zero_()

    def forward(self, x, bias: bool = True):
        g = self.env_group
        w = _used(self.weight, x.dtype, g)
        return F.linear(x, w, _used(self.bias, x.dtype, g) if bias else None)


class ActorCritic(nn.Module):
    """Two tanh layers of ``hidden`` units, a Gaussian policy head with a
    state-independent log std, and a value head.

    ``forward(x) -> (mean, log_std, value)`` with ``log_std`` broadcast
    to ``mean``'s shape. The parameters hold uninitialized memory until
    ``reset_parameters(generator)`` or a load fills them. ``shard(mesh)``
    splits the net over the mesh (module docstring)."""

    # the parameters that ``shard`` splits over 'model'
    MODEL_SPLIT = ("fc1.weight", "fc1.bias", "fc2.weight")
    env_group = model_group = None

    def __init__(self, obs_dim: int, hidden: int, act_dim: int = 2,
                 dtype=torch.float32, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.fc1 = _Dense(obs_dim, hidden, dev)
        self.fc2 = _Dense(hidden, hidden, dev)
        self.pi_mean = _Dense(hidden, act_dim, dev)
        self.vf = _Dense(hidden, 1, dev)
        self.pi_log_std = nn.Parameter(torch.full((act_dim,), -0.5,
                                                  dtype=dtype, device=dev))

    def reset_parameters(self, generator: torch.Generator) -> "ActorCritic":
        for layer in (self.fc1, self.fc2, self.pi_mean, self.vf):
            layer.reset_parameters(generator)
        with torch.no_grad():
            self.pi_log_std.fill_(-0.5)
        return self

    def shard(self, mesh) -> "ActorCritic":
        """Split over ``mesh`` in place (module docstring): the gradients
        summed over its 'env' axis, ``fc1`` and ``fc2`` split over its
        'model' axis. Nothing changes on a mesh of one rank."""
        self.env_group = axis_group(mesh, ENV_AXIS)
        for layer in (self.fc1, self.fc2, self.pi_mean, self.vf):
            layer.env_group = self.env_group
        group = self.model_group = axis_group(mesh, MODEL_AXIS)
        if group is not None:
            n, r = dist.get_world_size(group), dist.get_rank(group)
            hidden = self.fc1.weight.shape[0]
            if hidden % n:
                raise ValueError(f"hidden {hidden} does not split over "
                                 f"{n} 'model' shards")
            cut = slice(r * hidden // n, (r + 1) * hidden // n)
            self.fc1.weight = nn.Parameter(self.fc1.weight.detach()[cut].clone())
            self.fc1.bias = nn.Parameter(self.fc1.bias.detach()[cut].clone())
            self.fc2.weight = nn.Parameter(
                self.fc2.weight.detach()[:, cut].clone())
        return self

    def log_std(self) -> torch.Tensor:
        """``pi_log_std`` as the forward uses it."""
        return _used(self.pi_log_std, self.pi_log_std.dtype, self.env_group)

    def forward(self, x):
        h = torch.tanh(self.fc1(x))
        if self.model_group is None:
            h = torch.tanh(self.fc2(h))
        else:
            part = _SumOverModel.apply(self.fc2(h, bias=False),
                                       self.model_group)
            h = torch.tanh(part + _used(self.fc2.bias, h.dtype,
                                        self.env_group))
        mean = self.pi_mean(h)
        value = self.vf(h)[..., 0]
        return mean, self.log_std().expand(mean.shape), value


def featurize(obs: Dict[str, torch.Tensor], tables: ScanTables,
              obs_beams: int) -> torch.Tensor:
    """obs dict -> flat features (..., obs_beams + 2) for each agent.

    Scans mean-pool down to obs_beams and normalize by max_range; append
    normalized speed and yaw rate.
    """
    scans = obs["scans"]
    B = scans.shape[-1]
    stride = B // obs_beams
    pooled = scans[..., : obs_beams * stride]
    pooled = pooled.reshape(*pooled.shape[:-1], obs_beams, stride).mean(-1)
    pooled = pooled / tables.max_range
    v = obs["linear_vels_x"][..., None] / 10.0
    w = obs["ang_vels_z"][..., None] / 5.0
    return torch.cat([pooled, v, w], -1)


def gaussian_logp(mean, log_std, action):
    var = torch.exp(2.0 * log_std)
    return torch.sum(
        -0.5 * ((action - mean) ** 2 / var + 2.0 * log_std + _LOG_2PI), -1)


def scale_actions(raw, params: VehicleParams):
    """Map network outputs to [s_min, s_max] steer x [0, v_max] speed."""
    steer_lim = torch.stack([params.s_min.max(), params.s_max.max()]).abs().max()
    v_hi = params.v_max.max()
    steer = torch.tanh(raw[..., 0]) * steer_lim
    speed = (torch.tanh(raw[..., 1]) * 0.5 + 0.5) * v_hi
    return torch.stack([steer, speed], -1)


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))`` on the
    ``.grad`` of named parameters, updating them in place.

    The global norm is the square root of the sum of each gradient's
    squares, added in the sorted order of the names (flax's leaf order),
    each term promoting the total to the wider dtype, as optax's Python
    ``sum`` does. With a ``model_group``, the squares of the parameters
    named in ``split`` (each rank holds a slice) are summed over the group
    and the others counted once. Adam keeps its moments in each
    parameter's dtype and its step count as an int64 tensor on the host.
    """

    def __init__(self, named_params: Dict[str, torch.Tensor], lr: float,
                 max_grad_norm: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, model_group=None,
                 split: Tuple[str, ...] = ()):
        self.params = dict(sorted(named_params.items()))
        self.model_group, self.split = model_group, split
        self.lr, self.max_grad_norm = lr, max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = torch.zeros((), dtype=torch.int64)
        self.mu = {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for k, p in self.params.items()}

    def zero_grad(self):
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self):
        with annotate("ppo.adam"):
            grads = {k: p.grad for k, p in self.params.items()}
            # optax's sum: in leaf order, each 0-d term promoting the total;
            # the split parameters' part first, summed over 'model'
            split = all_reduce_sum(sum(torch.sum(grads[k] * grads[k])
                                       for k in self.split),
                                   self.model_group)
            norm = torch.sqrt(split + sum(torch.sum(g * g) for k, g in
                                          grads.items()
                                          if k not in self.split))
            keep = norm < self.max_grad_norm
            self.count += 1
            n = int(self.count)
            bc1 = 1.0 - self.b1 ** n
            bc2 = 1.0 - self.b2 ** n
            for k, p in self.params.items():
                g = grads[k]
                g = torch.where(keep, g,
                                (g / norm.to(g.dtype)) * self.max_grad_norm)
                mu = (1.0 - self.b1) * g + self.b1 * self.mu[k]
                nu = (1.0 - self.b2) * (g ** 2) + self.b2 * self.nu[k]
                self.mu[k], self.nu[k] = mu, nu
                update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                p.add_(update * -self.lr)

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count.clone(), "mu": dict(self.mu),
                "nu": dict(self.nu)}

    def load_state_dict(self, state: Dict[str, object]):
        self.count = torch.as_tensor(state["count"], dtype=torch.int64).clone()
        for moments, name in ((self.mu, "mu"), (self.nu, "nu")):
            for k in moments:
                moments[k] = state[name][k].to(moments[k].device,
                                               moments[k].dtype).clone()


@dataclasses.dataclass
class TrainState:
    """The learner's state. ``net`` and ``opt`` are updated in place by
    ``PPO.train_step``; ``env_states`` is replaced. ``generator`` draws the
    policy noise and the permutations; ``env_generator`` is the env
    step's own (None when the step has none)."""

    net: ActorCritic
    opt: ClippedAdam
    env_states: SimState
    generator: torch.Generator
    env_generator: Optional[torch.Generator] = None


class PPO:
    """PPO over a batched env on ``device`` (default: the card), or over
    the ranks of ``mesh`` (module docstring; the device is then the
    rank's)."""

    def __init__(
        self,
        params: VehicleParams,
        map_data: MapData,
        tables: ScanTables,
        cfg: SimConfig,
        timestep: float,
        ppo_cfg: PPOConfig = PPOConfig(),
        step_fn: Optional[Callable] = None,  # e.g. make_autoreset_step's
        device=None,
        mesh=None,
        sort_fn: Optional[Callable] = None,  # states -> states, each rollout
    ):
        if device is None and mesh is not None:
            device = local_device(mesh)
        self.device = resolve_device(device)
        self.mesh = mesh
        self._env_index, self._env_count = env_shard(mesh)
        self._env_group = axis_group(mesh, ENV_AXIS)
        self.params = params
        self.map_data = map_data
        self.tables = tables
        self.cfg = cfg
        self.timestep = timestep
        self.pc = ppo_cfg
        self.step_fn = step_fn
        self.sort_fn = sort_fn
        if step_fn is None:
            self.env_generator = make_generator(
                self.device, DEFAULT_SEED + self._env_index)
            # on the card once, so that no step copies it there
            self._timestep = torch.as_tensor(timestep, dtype=cfg.torch_dtype,
                                             device=self.device)
        else:
            self.env_generator = getattr(step_fn, "generator", None)

    def _step(self, states, actions):
        if self.step_fn is not None:
            return self.step_fn(states, actions)
        return batch_step(states, actions, self.params, self.map_data,
                          self.tables, self.cfg, self._timestep,
                          self.env_generator)

    # ------------------------------------------------------------- init
    def init(self, env_states: SimState,
             generator: torch.Generator) -> TrainState:
        """Draw the net from ``generator``, which then stays the learner's
        (under a mesh: the full net on every rank, then its slice)."""
        net = ActorCritic(self.pc.obs_beams + 2, self.pc.hidden,
                          dtype=self.cfg.torch_dtype,
                          device=self.device).reset_parameters(generator)
        net.shard(self.mesh)
        opt = ClippedAdam(dict(net.named_parameters()), self.pc.lr,
                          self.pc.max_grad_norm, model_group=net.model_group,
                          split=ActorCritic.MODEL_SPLIT)
        return TrainState(net, opt, env_states, generator, self.env_generator)

    # ------------------------------------------------------------- rollout
    def _obs_of(self, states: SimState):
        return {
            "scans": states.scans,
            "linear_vels_x": states.x[..., 3],
            "ang_vels_z": states.x[..., 5],
        }

    def _policy(self, net, generator, feats):
        mean, log_std, value = net(feats)
        # drawn for the global batch; this rank's rows (module docstring)
        E = mean.shape[0]
        noise = torch.randn((E * self._env_count,) + mean.shape[1:],
                            generator=generator, dtype=mean.dtype,
                            device=mean.device)
        noise = noise[self._env_index * E:(self._env_index + 1) * E]
        raw = mean + torch.exp(log_std) * noise
        logp = gaussian_logp(mean, log_std, raw)
        return raw, logp, value

    def _shaped_reward(self, states: SimState, done):
        """Progress-style shaping, PER AGENT (E, A): forward speed minus
        crash penalty. With an auto-reset step the states of done envs are
        already fresh (speed 0, no collision), as in the JAX package."""
        v = states.x[..., 3]
        crash = states.collisions
        return (self.pc.speed_reward * v * self.timestep
                - self.pc.crash_penalty * crash)

    @torch.no_grad()
    def rollout(self, ts: TrainState):
        """Collect rollout_steps transitions for every agent of each env.

        Returns (ts', traj, value_T): traj holds (T, E, A, ...) tensors
        ``feats``, ``raw``, ``logp``, ``value``, ``reward`` and (T, E)
        ``done``; value_T bootstraps the last state."""
        pc = self.pc
        states = ts.env_states
        out = {k: [] for k in ("feats", "raw", "logp", "value", "reward",
                               "done")}
        with annotate("ppo.rollout", extent=True):
            for _ in range(pc.rollout_steps):
                with annotate("ppo.policy"):
                    feats = featurize(self._obs_of(states), self.tables,
                                      pc.obs_beams)
                    raw, logp, value = self._policy(ts.net, ts.generator,
                                                    feats)
                    actions = scale_actions(raw, self.params)
                states, _, _, done, _ = self._step(states, actions)
                reward = self._shaped_reward(states, done)
                for k, v in (("feats", feats), ("raw", raw), ("logp", logp),
                             ("value", value), ("reward", reward),
                             ("done", done)):
                    out[k].append(v)
            traj = {k: torch.stack(v) for k, v in out.items()}
            feats_T = featurize(self._obs_of(states), self.tables,
                                pc.obs_beams)
            _, _, value_T = ts.net(feats_T)
        COUNTERS["ppo.rollout.steps"] += pc.rollout_steps
        return dataclasses.replace(ts, env_states=states), traj, value_T

    # ------------------------------------------------------------- losses
    def _gae(self, traj, value_T):
        pc = self.pc
        values = traj["value"]  # (T, E, A)
        rewards = traj["reward"]  # (T, E, A)
        dones = traj["done"].to(values.dtype)[..., None]  # (T, E, 1)
        gae = torch.zeros_like(value_T)
        next_value = value_T
        advs = [None] * values.shape[0]
        for t in reversed(range(values.shape[0])):
            delta = (rewards[t] + pc.gamma * next_value * (1 - dones[t])
                     - values[t])
            gae = delta + pc.gamma * pc.gae_lambda * (1 - dones[t]) * gae
            advs[t] = gae
            next_value = values[t]
        advs = torch.stack(advs)
        return advs, advs + values

    def _loss_part(self, net, batch, mb_size: int):
        """This rank's part of the clipped PPO loss over a minibatch of
        ``mb_size`` samples, of which ``batch`` holds the rank's: the ranks'
        parts sum to the loss (module docstring). Returns (part, aux) with
        the rank's parts of the policy and value terms and the entropy."""
        pc = self.pc
        mean, log_std, value = net(batch["feats"])
        logp = gaussian_logp(mean, log_std, batch["raw"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]  # (N, A): per-agent advantages
        n = mb_size * adv.shape[-1]
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - pc.clip_eps, 1 + pc.clip_eps) * adv
        pg_loss = -torch.minimum(pg1, pg2).sum() / n
        v_loss = 0.5 * ((value - batch["ret"]) ** 2).sum() / n
        ent = torch.sum(net.log_std() + 0.5 * math.log(2 * np.pi * np.e))
        share = adv.shape[0] / mb_size
        total = pg_loss + pc.vf_coef * v_loss - pc.ent_coef * share * ent
        return total, dict(pg=pg_loss, vf=v_loss, ent=ent)

    def _loss(self, net, batch):
        """The loss of ``batch`` as one whole minibatch (JAX ``_loss``)."""
        return self._loss_part(net, batch, batch["adv"].shape[0])

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the global batch."""
        return (all_reduce_sum(x.sum(), self._env_group)
                / (x.numel() * self._env_count))

    def _normalize(self, advs: torch.Tensor) -> torch.Tensor:
        """Advantages less their mean over their population std, over the
        global batch."""
        mean = self._mean(advs)
        std = torch.sqrt(self._mean((advs - mean) ** 2))
        return (advs - mean) / (std + 1e-8)

    def _own(self, take: torch.Tensor, E: int) -> torch.Tensor:
        """The local flat indices of the samples of ``take`` (global flat
        indices ``t * E_global + e``) whose env is this rank's."""
        t, e = take // (E * self._env_count), take % (E * self._env_count)
        mine = e // E == self._env_index
        return (t * E + e - self._env_index * E)[mine]

    # ------------------------------------------------------------- train
    def update(self, ts: TrainState, traj, value_T):
        """GAE, then epochs x minibatch clipped-PPO updates of ``ts.net``
        (in place). Returns (ts, metrics) with 0-d tensor metrics."""
        with annotate("ppo.update", extent=True):
            pc = self.pc
            with annotate("ppo.gae"):
                advs, returns = self._gae(traj, value_T)
            advs = self._normalize(advs)

            T, E, A = advs.shape
            flat = dict(
                feats=traj["feats"].reshape(T * E, *traj["feats"].shape[2:]),
                raw=traj["raw"].reshape(T * E, *traj["raw"].shape[2:]),
                logp=traj["logp"].reshape(T * E, *traj["logp"].shape[2:]),
                adv=advs.reshape(T * E, A),
                ret=returns.reshape(T * E, A),
            )
            n_all = T * E * self._env_count
            mb_size = n_all // pc.minibatches
            epoch_losses = []
            for _ in range(pc.epochs):
                perm = torch.randperm(n_all, generator=ts.generator,
                                      device=advs.device)
                losses = []
                for i in range(pc.minibatches):
                    take = self._own(perm[i * mb_size:(i + 1) * mb_size], E)
                    batch = {k: v[take] for k, v in flat.items()}
                    ts.opt.zero_grad()
                    with annotate("ppo.minibatch"):
                        loss, _ = self._loss_part(ts.net, batch, mb_size)
                        loss.backward()
                    COUNTERS["ppo.update.samples"] += take.numel() * A
                    ts.opt.step()
                    losses.append(loss.detach())
                epoch_losses.append(torch.stack(losses))
            # the ranks' parts of each minibatch's loss sum to its loss
            losses = all_reduce_sum(torch.stack(epoch_losses),
                                    self._env_group)
            metrics = dict(
                loss=torch.stack([row.mean() for row in losses]).mean(),
                mean_reward=self._mean(traj["reward"]),
                crash_rate=self._mean(
                    traj["done"].to(traj["reward"].dtype)),
            )
            return ts, metrics

    def train_step(self, ts: TrainState):
        """One PPO iteration: the sort (with ``sort_fn``), the rollout,
        then ``update``."""
        with annotate("ppo.iteration", extent=True):
            if self.sort_fn is not None:
                with annotate("ppo.sort"):
                    ts = dataclasses.replace(
                        ts, env_states=self.sort_fn(ts.env_states))
            out = self.update(*self.rollout(ts))
        COUNTERS["ppo.iterations"] += 1
        return out
