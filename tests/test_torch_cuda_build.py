"""PyTorch port: the hand-written kernels as ``utils/cuda_build.py``
declares them, on the CPU.

Each declaration must agree with its CUDA source: the ``__global__`` name
a trace of the card shows, both ``extern "C"`` entries, their argument
types, and the names of the occupancy query's outputs; every source under
``csrc/`` has one declaration, and a declared span is one the port
opens. Without the check such drift shows only on the card. A fake library stands in for the built one: a launch passes the
stream and raises, naming the kernel, on a CUDA error code; an occupancy
query reads the outputs and the current device's SM count; and each ops
wrapper's launch arguments convert to the declared ctypes types. Nothing
here builds a kernel or needs a card.
"""

import ctypes
import glob
import os
import re
import types

import numpy as np
import pytest
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.ops import opp_clip_kernel as oc
from f1tenth_gym_tpu_torch.ops import overlay_kernel as ok
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
from f1tenth_gym_tpu_torch.utils import cuda_build
from f1tenth_gym_tpu_torch.utils.cuda_build import KERNELS

LABELS = [k.label for k in KERNELS]
STREAM = 0x5EED
SMS = 132


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _kernel(label):
    return next(k for k in KERNELS if k.label == label)


def _c_params(k, entry):
    """[(C type without spaces, name)] of ``extern "C" int <entry>(...)``
    in the kernel's source."""
    with open(k.src) as f:
        src = f.read()
    m = re.search(r'extern\s+"C"\s+int\s+' + entry + r"\s*\(([^)]*)\)", src)
    assert m, f'{k.src}: no extern "C" int {entry}(...)'
    params = []
    for p in m.group(1).split(","):
        ctype, name = re.fullmatch(r"(.*?[\s*])(\w+)",
                                   " ".join(p.split())).groups()
        params.append((ctype.replace(" ", ""), name))
    return params


def _ctypes_of(params, pointer):
    scalar = {"int": ctypes.c_int, "float": ctypes.c_float}
    return [pointer if t.endswith("*") else scalar[t] for t, _ in params]


@pytest.mark.parametrize("label", LABELS)
def test_declared_names_are_in_the_source(label):
    k = _kernel(label)
    with open(k.src) as f:
        src = f.read()
    glob_fn = (r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
               + re.escape(k.trace_name) + r"\s*\(")
    assert re.search(glob_fn, src), f"{k.src}: no __global__ {k.trace_name}"
    for entry in (k.entry, k.occupancy_entry):
        assert _c_params(k, entry)


@pytest.mark.parametrize("label", LABELS)
def test_declared_argtypes_match_the_source(label):
    """The launch: the source's parameters, pointers as ``void*`` and the
    stream last; the query: its shape, then an ``int*`` for each declared
    output, named as in the source."""
    k = _kernel(label)
    declared = k.argtypes()
    launch = _c_params(k, k.entry)
    assert launch[-1] == ("void*", "stream")
    assert declared[k.entry] == _ctypes_of(launch, ctypes.c_void_p)
    occ = _c_params(k, k.occupancy_entry)
    assert declared[k.occupancy_entry] == _ctypes_of(
        occ, ctypes.POINTER(ctypes.c_int))
    outs = occ[len(k.occupancy_args):]
    assert all(t == "int*" for t, _ in outs)
    assert tuple(name for _, name in outs) == k.occupancy_outs
    assert k.occupancy_outs[0] == "grid_blocks"


def test_every_source_is_declared_once():
    """One declaration a ``csrc/*.cu`` file; labels and trace names
    unique, and no trace name inside another (``card_launches`` counts a
    kernel by the names that contain its trace name); the ops wrappers
    launch through theirs."""
    stems = sorted(os.path.basename(p)[:-3]
                   for p in glob.glob(os.path.join(cuda_build.CSRC_DIR,
                                                   "*.cu")))
    assert sorted(k.stem for k in KERNELS) == stems
    assert len({k.label for k in KERNELS}) == len(KERNELS)
    names = [k.trace_name for k in KERNELS]
    assert all(a == b or a not in b for a in names for b in names)
    assert (sk.KERNEL, ok.KERNEL, oc.KERNEL) == KERNELS


@pytest.mark.parametrize("label", [k.label for k in KERNELS if k.span])
def test_declared_span_is_annotated(label):
    """A declared span is one the port opens (``annotate``): the span
    ``tools/step_trace`` credits the kernel's time to."""
    k = _kernel(label)
    pkg = os.path.dirname(cuda_build.CSRC_DIR)
    opened = ""
    for path in glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True):
        with open(path) as f:
            opened += f.read()
    assert f'annotate("{k.span}"' in opened


class _FakeLib:
    """The two entries of a kernel's library: each call recorded; the
    launch returns ``code``, the query writes 100, 101, ... to its outputs
    and returns ``per_sm``."""

    def __init__(self, k, code=0, per_sm=4):
        self.calls = []

        def launch(*args):
            self.calls.append(args)
            return code

        def occupancy(*args):
            self.calls.append(args)
            for i, ref in enumerate(args[len(k.occupancy_args):]):
                ref._obj.value = 100 + i
            return per_sm

        setattr(self, k.entry, launch)
        setattr(self, k.occupancy_entry, occupancy)


@pytest.fixture
def fake_card(monkeypatch):
    """The current stream and device as the card would give them."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=STREAM))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=SMS))

    def install(k, **kw):
        lib = _FakeLib(k, **kw)
        monkeypatch.setattr(k, "_lib", lib)
        return lib

    return install


@pytest.mark.parametrize("label", LABELS)
def test_launch_passes_the_stream_and_raises_on_error(label, fake_card):
    k = _kernel(label)
    args = tuple(range(len(k.args)))
    lib = fake_card(k)
    k.launch(torch.device("cpu"), *args)
    assert lib.calls == [args + (STREAM,)]
    fake_card(k, code=700)
    with pytest.raises(RuntimeError, match=re.escape(
            f"{k.label} ({k.trace_name}) launch failed: CUDA error 700")):
        k.launch(torch.device("cpu"), *args)


@pytest.mark.parametrize("label", LABELS)
def test_occupancy_reads_outputs_and_raises_on_error(label, fake_card):
    k = _kernel(label)
    shape = tuple(range(1, len(k.occupancy_args) + 1))
    lib = fake_card(k, per_sm=4)
    got = k.occupancy(*shape)
    assert lib.calls[0][:len(shape)] == shape
    outs = {name: 100 + i for i, name in enumerate(k.occupancy_outs)}
    assert got == dict(blocks_per_sm=4, **outs, waves=100 / (4 * SMS))
    assert list(got) == ["blocks_per_sm", *k.occupancy_outs, "waves"]
    fake_card(k, per_sm=-1)
    with pytest.raises(RuntimeError, match=re.escape(
            f"{k.label} ({k.trace_name}) occupancy query failed")):
        k.occupancy(*shape)


def _launch_k1():
    seg = torch.as_tensor(sk.build_seg_table(np.array(
        [[-5, -5, 5, -5], [5, -5, 5, 5], [5, 5, -5, 5], [-5, 5, -5, -5]],
        dtype=np.float32)))
    tables = P.make_scan_tables(num_beams=16, device="cpu")
    w = sk.prepare(torch.zeros(8, 3), seg, tables, 16, 2000)
    return sk._sweep_cuda(w), sk.sweep


def _launch_k2():
    g = torch.Generator().manual_seed(0)
    tables = P.make_scan_tables(num_beams=16, device="cpu")
    boxes = torch.rand(6, 1, 4, 2, generator=g) * 4 + 1
    w = ok.prepare_overlay(torch.full((6, 16), 9.0), torch.zeros(6, 3),
                           boxes, tables, 16)
    return ok._overlay_cuda(w), ok.overlay


def _launch_k3():
    tables = P.make_scan_tables(num_beams=16, device="cpu")
    x = torch.zeros(3, 2, 7)
    x[:, 1, 0] = 2.0
    verts = torch.rand(3, 2, 4, 2, generator=torch.Generator().manual_seed(1))
    return (oc._opp_clip_cuda(x, torch.full((3, 2, 16), 9.0), verts, tables),
            oc.opp_clip)


@pytest.mark.parametrize("label,launch", [("K1", _launch_k1),
                                          ("K2", _launch_k2),
                                          ("K3", _launch_k3)])
def test_wrapper_launch_arguments_fit_the_declaration(label, launch,
                                                      fake_card,
                                                      monkeypatch):
    """Each wrapper's kernel path, run on CPU tensors into the fake
    library: one call, every argument accepted by its declared ctypes
    type, the stream last, one count on the wrapper's ``launches``."""
    k = _kernel(label)
    lib = fake_card(k)
    for counter in (sk.sweep, ok.overlay, oc.opp_clip):
        monkeypatch.setattr(counter, "launches", 0)
    _, wrapper = launch()
    (call,) = lib.calls
    types_ = k.argtypes()[k.entry]
    assert len(call) == len(types_) and call[-1] == STREAM
    for t, a in zip(types_, call):
        t.from_param(a)
    assert wrapper.launches == 1
