"""K3's device time a racing step, in ms: the opponent clip's kernel
(``f1tenth_gym_tpu_torch/csrc/opp_clip_kernel.cu``), found by its kernel
name ``opp_clip_kernel`` among the device operations of the profiled
stretch that the layer record keeps (``breakdown["device_ops"]``, the
stretch's top operations by device time), summed over its entries and
divided by the stretch's steps. A kernel name holds whether the step ran
eagerly or as a replay of its CUDA graph. None in another kind of cell,
without opponents, or where K3 is not among those operations."""

K3_NAME = "opp_clip_kernel"


def read(rec):
    if rec.get("kind") != "race" or not rec.get("steps"):
        return None
    seconds = [s for name, s in rec.get("breakdown", {}).get("device_ops", [])
               if K3_NAME in name]
    if not seconds:
        return None
    return 1e3 * sum(seconds) / rec["steps"]
