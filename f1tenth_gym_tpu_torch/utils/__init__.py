"""Map loading and the distance transform (JAX ``utils/__init__.py``'s
exports)."""

from f1tenth_gym_tpu_torch.utils.edt import euclidean_distance_transform
from f1tenth_gym_tpu_torch.utils.map_loader import load_map, make_map_data

__all__ = ["load_map", "make_map_data", "euclidean_distance_transform"]
