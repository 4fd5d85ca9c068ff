"""Plain reference of the learner: PPO's policy, GAE, clipped loss, its
gradient and ``optax.chain(clip_by_global_norm, adam)``, in float64.

Plain ``torch``, one function a step of the algorithm, with no batching
trick, no kernel and no cache; it imports nothing of the port or of the JAX
package. Every computation runs in ``dtype`` (float64 unless a control asks
for a lower one) and the card's TF32 paths are turned off, at import and
again at every entry, so that a float32 matrix product of a caller cannot
leak into it.

The net is the actor-critic of f1tenth_gym_tpu's learner: flax ``Dense``
layers (parameters stored in float32, cast up here), two tanh layers of
``hidden`` units, a Gaussian head with a state-independent log std and a
value head. Parameters are a dict by name: ``fc1.weight`` (out, in),
``fc1.bias``, ``fc2.*``, ``pi_mean.*``, ``vf.*`` and ``pi_log_std``.

PPO is Schulman et al. 2017 (arXiv:1707.06347) as OpenAI baselines'
``ppo2`` runs it, with these departures, each the learner's own:

* one policy drives every car of an env; rewards, values and GAE are per
  car, and a done env ends the episode of all its cars;
* the reward is shaped: forward speed times dt less a crash penalty, read
  from the states after the step's auto-reset;
* advantages are normalized once over the whole iteration's batch, by the
  population std (ddof 0), not per minibatch;
* the value loss is not clipped; the policy and value terms are means over
  the minibatch's car-samples; the entropy is that of the Gaussian's log
  std, which does not depend on the sample;
* actions are squashed by tanh after sampling and the log-probability is
  that of the unsquashed sample (no change-of-variables term);
* gradients are clipped by their global norm (left alone below the limit,
  scaled by limit / norm above it), then Adam with eps outside the square
  root, as optax's ``adam``; bias corrections from the step count.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

LEAVES = ("fc1.bias", "fc1.weight", "fc2.bias", "fc2.weight",
          "pi_log_std", "pi_mean.bias", "pi_mean.weight", "vf.bias",
          "vf.weight")   # flax's leaf order: sorted by name
LOG_2PI = math.log(2.0 * math.pi)


def exact():
    """The card's float32 matrix products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


exact()


def cast(params: Dict[str, torch.Tensor], dtype=torch.float64) -> dict:
    """Each parameter as a fresh ``dtype`` leaf."""
    return {k: params[k].detach().to(dtype) for k in LEAVES}


def featurize(scans, vx, wz, obs_beams: int, max_range: float):
    """(..., B) scans, (...) speed and yaw rate -> (..., obs_beams + 2):
    the scan mean-pooled in groups of B // obs_beams beams (the tail left
    out) over the range, the speed over 10 m/s, the yaw rate over 5 rad/s."""
    exact()
    B = scans.shape[-1]
    stride = B // obs_beams
    pooled = scans[..., :obs_beams * stride].reshape(
        *scans.shape[:-1], obs_beams, stride).mean(-1) / max_range
    return torch.cat([pooled, (vx / 10.0)[..., None], (wz / 5.0)[..., None]],
                     -1)


def forward(p: dict, x):
    """(mean, log_std broadcast to mean, value) of features ``x``."""
    exact()
    h = torch.tanh(x @ p["fc1.weight"].T + p["fc1.bias"])
    h = torch.tanh(h @ p["fc2.weight"].T + p["fc2.bias"])
    mean = h @ p["pi_mean.weight"].T + p["pi_mean.bias"]
    value = (h @ p["vf.weight"].T + p["vf.bias"])[..., 0]
    return mean, p["pi_log_std"].expand(mean.shape), value


def gaussian_logp(mean, log_std, action):
    """Log density of ``action`` under N(mean, exp(log_std)^2), summed over
    the last axis."""
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * (z * z + 2.0 * log_std + LOG_2PI), -1)


def policy(p: dict, feats, noise):
    """The rollout's policy on ``feats`` with the standard-normal ``noise``:
    (raw action, its log-probability, value)."""
    mean, log_std, value = forward(p, feats)
    raw = mean + torch.exp(log_std) * noise
    return raw, gaussian_logp(mean, log_std, raw), value


def scale_actions(raw, steer_limit: float, v_max: float):
    """Raw actions -> [steer, speed]: tanh to [-steer_limit, steer_limit]
    and to [0, v_max]."""
    steer = torch.tanh(raw[..., 0]) * steer_limit
    speed = (torch.tanh(raw[..., 1]) * 0.5 + 0.5) * v_max
    return torch.stack([steer, speed], -1)


def shaped_reward(vx, collisions, dt: float, speed_reward: float,
                  crash_penalty: float):
    """Per car: speed_reward * vx * dt - crash_penalty * collision, of the
    states after the step (and its auto-reset)."""
    return speed_reward * vx * dt - crash_penalty * collisions


def gae(values, rewards, dones, value_T, gamma: float, lam: float):
    """Generalized advantage estimation over (T, E, A) values and rewards,
    (T, E) dones and the (E, A) bootstrap value: (advantages, returns)."""
    T = values.shape[0]
    mask = 1.0 - dones.to(values.dtype)[..., None]
    advs = torch.zeros_like(values)
    run = torch.zeros_like(value_T)
    next_value = value_T
    for t in range(T - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * mask[t] - values[t]
        run = delta + gamma * lam * mask[t] * run
        advs[t] = run
        next_value = values[t]
    return advs, advs + values


def normalize(advs):
    """Advantages less their mean over their population std (+1e-8)."""
    mean = advs.mean()
    std = torch.sqrt(((advs - mean) ** 2).mean())
    return (advs - mean) / (std + 1e-8)


def loss(p: dict, batch: dict, clip_eps: float, vf_coef: float,
         ent_coef: float):
    """The clipped PPO loss of one minibatch: (total, {pg, vf, ent}).
    ``batch``: (N, A, F) feats, (N, A, 2) raw, (N, A) logp, adv, ret."""
    mean, log_std, value = forward(p, batch["feats"])
    logp = gaussian_logp(mean, log_std, batch["raw"])
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["adv"]
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    pg = -torch.minimum(ratio * adv, clipped * adv).mean()
    vf = 0.5 * ((value - batch["ret"]) ** 2).mean()
    ent = torch.sum(p["pi_log_std"] + 0.5 * math.log(2.0 * math.pi * math.e))
    return pg + vf_coef * vf - ent_coef * ent, dict(pg=pg, vf=vf, ent=ent)


def loss_and_grad(p: dict, batch: dict, clip_eps: float, vf_coef: float,
                  ent_coef: float):
    """``loss`` and its gradient by autograd: (total, terms, {name: grad})."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    total, terms = loss(leaves, batch, clip_eps, vf_coef, ent_coef)
    grads = torch.autograd.grad(total, [leaves[k] for k in LEAVES])
    return (total.detach(), {k: v.detach() for k, v in terms.items()},
            dict(zip(LEAVES, grads)))


def global_norm(grads: dict):
    return torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in LEAVES))


def clipped_adam(grads: dict, mu: dict, nu: dict, count: int, lr: float,
                 max_grad_norm: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, clip: Optional[bool] = None):
    """One step of clip-by-global-norm then Adam from the moments ``mu``,
    ``nu`` after ``count`` steps: ({name: parameter change}, mu', nu',
    the global norm). ``clip`` forces a branch of the clip (None: the
    norm decides)."""
    norm = global_norm(grads)
    if clip is None:
        clip = bool(norm >= max_grad_norm)
    n = count + 1
    bc1, bc2 = 1.0 - b1 ** n, 1.0 - b2 ** n
    change, mu2, nu2 = {}, {}, {}
    for k in LEAVES:
        g = grads[k] / norm * max_grad_norm if clip else grads[k]
        mu2[k] = (1.0 - b1) * g + b1 * mu[k]
        nu2[k] = (1.0 - b2) * g * g + b2 * nu[k]
        change[k] = -lr * (mu2[k] / bc1) / (torch.sqrt(nu2[k] / bc2) + eps)
    return change, mu2, nu2, norm
