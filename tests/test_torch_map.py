"""PyTorch port: map readers, distance transform, wall segments, culling pack.

Host-side map preprocessing must give the JAX package's arrays byte for
byte: the kernel tables and the culled window pack are built from them,
and any difference changes which segments a scan sweeps.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from f1tenth_gym_tpu.maps import available_maps, map_path
from f1tenth_gym_tpu.ops.culling import build_tile_tables as j_build_tiles
from f1tenth_gym_tpu.utils.map_loader import load_map as j_load_map
from f1tenth_gym_tpu.utils.map_loader import load_map_image as j_load_image
from f1tenth_gym_tpu_torch.ops.culling import build_tile_tables as p_build_tiles
from f1tenth_gym_tpu_torch.utils import image_io, native
from f1tenth_gym_tpu_torch.utils.map_loader import load_map as p_load_map
from f1tenth_gym_tpu_torch.utils.map_loader import load_map_image as p_load_image

MAPS = available_maps()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_all_nine_bundled_maps_listed():
    from f1tenth_gym_tpu_torch.maps import available_maps as p_available

    assert len(MAPS) == 9
    assert p_available() == MAPS


@pytest.mark.parametrize("name", MAPS)
def test_png_reader_equals_pillow(name):
    png = os.path.splitext(map_path(name))[0] + ".png"
    np.testing.assert_array_equal(image_io.read_png(png),
                                  np.array(Image.open(png)))


@pytest.mark.parametrize("name", MAPS)
def test_yaml_reader_equals_pyyaml(name):
    with open(map_path(name)) as f:
        want = yaml.safe_load(f)
    got = image_io.read_map_yaml(map_path(name))
    assert got == want
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}


@pytest.mark.parametrize("name", ["berlin", "compact"])
def test_dt_segments_seg_table_byte_equal(name):
    ref = j_load_map(map_path(name), ".png", dtype=jnp.float32,
                     extract_segments=True)
    ours = p_load_map(map_path(name), dtype=torch.float32,
                      extract_segments=True, device="cpu")
    for field in ("dt", "segments", "seg_table"):
        want = np.asarray(getattr(ref, field))
        got = getattr(ours, field).numpy()
        assert got.dtype == want.dtype, field
        assert got.tobytes() == want.tobytes(), field


@pytest.mark.parametrize("name,tile_size,split_cap", [
    ("compact", 2.0, 0),
    ("compact", 2.0, 96),
    ("berlin", 1.25, 0),
])
def test_culling_pack_byte_equal(name, tile_size, split_cap):
    """Uncached builds of the v9 pack with erosion fusion, from each
    package's own segments and bitmap: every array and scalar equal."""
    ref_map = j_load_map(map_path(name), ".png", dtype=jnp.float32,
                         extract_segments=True)
    ours_map = p_load_map(map_path(name), dtype=torch.float32,
                          extract_segments=True, device="cpu")
    from f1tenth_gym_tpu.utils.map_loader import load_map_yaml

    res, origin, _ = load_map_yaml(map_path(name))
    img = os.path.splitext(map_path(name))[0] + ".png"
    ref_bitmap, our_bitmap = j_load_image(img), p_load_image(img)
    np.testing.assert_array_equal(our_bitmap, ref_bitmap)
    kw = dict(tile_size=tile_size, split_cap_groups=split_cap,
              resolution=res, origin=origin)
    ref = j_build_tiles(np.asarray(ref_map.segments), 30.0,
                        bitmap=ref_bitmap, **kw)
    ours = p_build_tiles(ours_map.segments.numpy(), 30.0,
                         bitmap=our_bitmap, **kw)
    assert ours.eligible is not None and ref.eligible is not None
    for field in ("tables", "ngroups", "blockmap", "ext", "eligible"):
        want, got = getattr(ref, field), getattr(ours, field)
        assert got.dtype == want.dtype and got.shape == want.shape, field
        assert got.tobytes() == want.tobytes(), field
    for field in ("x0", "y0", "tile_size", "nx", "ny", "neighborhood"):
        assert getattr(ours, field) == getattr(ref, field), field
    if split_cap:
        assert (ours.ext % 256).any()   # the split layout is exercised


def test_native_library_is_the_ports_own():
    lib = native.load()
    assert lib is not None
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert os.path.dirname(native.SO_PATH) == os.path.join(pkg, "_build")
    assert native.NATIVE_DIR == os.path.join(pkg, "native")
    assert os.path.abspath(lib._name) == native.SO_PATH
    srcs = sorted(os.listdir(native.NATIVE_DIR))
    assert srcs == ["contour.cpp", "edt.cpp", "visibility.cpp"]
