"""The learner cell at a size the CPU runs in seconds: dr16_2car_ppo's
configuration on a 2-track world with 64 beams and no culling pack, 16
envs, a net of 32 hidden units over 16 pooled beams, 8 rollout steps and
2 x 2 minibatches. Not collected (no ``test_`` prefix)."""

import copy
import time

from benchmark import ppo, spec

SEED = 2**31 + 4321   # larger than 32 signed bits hold


def small_cell():
    cell = copy.deepcopy(spec.cell(spec.load(), "dr16-ppo-4096"))
    cfg = cell["config"]
    cfg["world"].update(tracks=2)
    cfg.update(num_beams=64, culling_tile_size=None)
    cfg["learner"].update(obs_beams=16, obs_dim=18, hidden=32,
                          rollout_steps=8, epochs=2, minibatches=2)
    cell["traffic"].update(envs=16, warmup_iterations=1,
                           check=dict(sample_envs=6, first_iterations=2))
    return cell


def run_small(seed=SEED, trace=False, **kw):
    return ppo.run(small_cell(), seed, 0.0, trace, "cpu", time.time(), **kw)
