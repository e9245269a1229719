"""The port's roofline (``roofline/analysis.py``) and its trace cost model
(``roofline/trace_cost.py``, in the place of the reference's HLO parser
``hlo_cost``), with the small ports around them, against the reference.

* ``analysis.model_flops`` equals the reference's (``==``) on every
  config, shape and device count of the dry run; ``kv_read_bytes_per_step``
  on every config; ``list_configs`` and ``get_profile_by_name`` too;
* ports of ``tests/test_roofline.py``'s ``TestAnalysis`` and of
  ``tests/test_autotune.py``'s two analysis tests (the constants are the
  H100's, the port having no TPU profile);
* counterparts of ``TestTripCounts``: a trace's FLOPs against the
  reference's ``hlo_cost.module_cost`` of the same function compiled by
  XLA, Python loops counted per iteration and ``trips`` loops counted
  once times their trip count;
* a reduced qwen2-1.5b train step: its matmul FLOPs equal
  ``FlopCounterMode``'s count; its total FLOPs against ``hlo_cost`` of
  the reference's jitted ``build_train_step`` on a one-device mesh;
  every tensor the trace makes is a FakeTensor, and a kernel wrapper
  reached in a trace raises (loops traced once and multiplied:
  ``test_torch_trace_loops.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.roofline import analysis as janalysis
from repro.roofline import hlo_cost
from repro_torch.common import loops
from repro_torch.configs import SHAPES, ShapeConfig, get_config, reduced
from repro_torch.configs.base import list_configs
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis, trace_cost
from repro_torch.roofline.hardware import H100_SXM, HOST_CPU

torch.set_num_threads(1)

CONFIGS = list_configs()


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile()


def _trace(fn, *shapes, unroll=False):
    return trace_cost.trace(
        fn, lambda: tuple(torch.empty(s) for s in shapes), unroll=unroll)


# ------------------------------------------------------------ the ports
@pytest.mark.parametrize("name", CONFIGS)
def test_model_flops_equal_reference(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    for shape in SHAPES:
        for n in (256, 512):
            assert analysis.model_flops(cfg, SHAPES[shape], n) == \
                janalysis.model_flops(jcfg, JSHAPES[shape], n), (shape, n)


@pytest.mark.parametrize("name", CONFIGS)
def test_kv_read_bytes_equal_reference(name):
    from repro.serving.kv_cache import kv_read_bytes_per_step as jkv
    from repro_torch.serving.kv_cache import kv_read_bytes_per_step
    cfg, jcfg = get_config(name), jax_get_config(name)
    for seq in (4096, 32768):
        for batch in (1, 8):
            for sp in (0.0, 0.5):
                assert kv_read_bytes_per_step(cfg, seq, batch, sp) == \
                    jkv(jcfg, seq, batch, sp), (seq, batch, sp)


def test_list_configs_and_profile_by_name_equal_reference():
    from repro.autotune.tuner import get_profile_by_name as jprof
    from repro.configs.base import list_configs as jlist
    from repro_torch.autotune.tuner import get_profile_by_name
    from repro_torch.configs import list_configs as exported
    assert list_configs() == exported() == jlist()
    assert get_profile_by_name("host_cpu") is HOST_CPU
    assert get_profile_by_name("h100_sxm") is H100_SXM
    a, b = get_profile_by_name("host_cpu"), jprof("host_cpu")
    assert (a.peak_flops, a.hbm_bw, a.ici_bw, a.mem_bytes) == \
        (b.peak_flops, b.hbm_bw, b.ici_bw, b.mem_bytes)
    with pytest.raises(KeyError):
        get_profile_by_name("tpu_v5e")


class TestAnalysis:
    def test_analyze_shape(self):
        tr = _trace(lambda a, b: torch.tanh(a @ b), (512, 512), (512, 512))
        r = analysis.analyze(tr, model_flops_per_device=2 * 512 ** 3)
        assert r.bottleneck in ("compute", "memory", "collective")
        assert r.flops == pytest.approx(2 * 512 ** 3, rel=0.01)
        assert 0.9 < r.useful_ratio < 1.1
        assert r.top_flops and r.top_bytes
        assert r.torch_flops == 2 * 512 ** 3
        d = r.as_dict()
        assert {"compute_t", "memory_t", "collective_t"} <= set(d)

    def test_model_flops_kinds(self):
        cfg = get_config("qwen2-1.5b")
        tr = analysis.model_flops(cfg, SHAPES["train_4k"], 256)
        pf = analysis.model_flops(cfg, SHAPES["prefill_32k"], 256)
        de = analysis.model_flops(cfg, SHAPES["decode_32k"], 256)
        assert tr > pf > de > 0


def test_analysis_constants_are_the_h100s():
    assert analysis.PEAK_FLOPS == H100_SXM.peak_flops
    assert analysis.HBM_BW == H100_SXM.hbm_bw
    assert analysis.ICI_BW == H100_SXM.ici_bw
    assert analysis.HBM_BYTES == H100_SXM.mem_bytes


def test_analyze_takes_profile():
    tr = _trace(lambda a, b: a @ b, (128, 128), (128, 128))
    r_card = analysis.analyze(tr)
    r_cpu = analysis.analyze(tr, hw=HOST_CPU)
    assert r_card.hw == "h100_sxm" and r_cpu.hw == "host_cpu"
    assert r_cpu.compute_t > r_card.compute_t  # slower envelope
    assert r_cpu.flops == r_card.flops         # counts are hw-free


# ------------------------------------------------------------ trip counts
class TestTripCounts:
    def test_tanh_matmul_against_hlo_cost(self):
        a = jax.ShapeDtypeStruct((512, 512), jnp.float32)
        ref = hlo_cost.module_cost(
            _compile(lambda x, y: jnp.tanh(x @ y), a, a).as_text())
        tr = _trace(lambda x, y: torch.tanh(x @ y), (512, 512), (512, 512))
        assert tr.cost.flops == pytest.approx(2 * 512 ** 3, rel=0.01)
        assert tr.cost.flops == pytest.approx(ref.flops, rel=0.01)

    def test_loop_of_matmuls_counts_each_trip(self):
        """10 matmuls at 256^2: a Python loop unrolled, a ``trips`` loop
        traced for 4 steps and multiplied, and the reference's scan."""
        def looped(x, ws):
            for i in range(10):
                x = x @ ws[i]
            return x

        def scanned(x, ws):
            for i in loops.trips(10, carry=True):
                x = x @ ws[i]
            return x

        expect = 10 * 2 * 256 ** 3
        shapes = ((256, 256), (10, 256, 256))
        assert _trace(looped, *shapes).cost.flops == expect
        assert _trace(scanned, *shapes).cost.flops == expect
        x = jax.ShapeDtypeStruct((256, 256), jnp.float32)
        w = jax.ShapeDtypeStruct((10, 256, 256), jnp.float32)
        ref = hlo_cost.module_cost(_compile(
            lambda c, ws: jax.lax.scan(lambda c, w: (c @ w, ()), c, ws)[0],
            x, w).as_text())
        assert ref.flops == pytest.approx(expect, rel=0.01)

    def test_nested_loops_multiply(self):
        def nested(x, ws):
            for _ in loops.trips(4):
                for j in loops.trips(6, carry=True):
                    x = torch.tanh(x @ ws[j])
            return x

        def ref_fn(x, ws):
            def outer(c, _):
                def inner(ci, w):
                    return jnp.tanh(ci @ w), ()
                return jax.lax.scan(inner, c, ws)[0], ()
            return jax.lax.scan(outer, x, None, length=4)[0]

        shapes = ((128, 128), (6, 128, 128))
        got = _trace(nested, *shapes)
        assert got.cost.flops == _trace(nested, *shapes, unroll=True).cost.flops
        expect = 4 * 6 * 2 * 128 ** 3
        x = jax.ShapeDtypeStruct((128, 128), jnp.float32)
        w = jax.ShapeDtypeStruct((6, 128, 128), jnp.float32)
        ref = hlo_cost.module_cost(_compile(ref_fn, x, w).as_text())
        assert got.cost.flops == pytest.approx(expect, rel=0.02)
        assert got.cost.flops == pytest.approx(ref.flops, rel=0.02)


# ------------------------------------------------------- train step traces
TRAIN = ShapeConfig("t", 32, 4, "train")


def _matmul_flops(cost):
    from torch.utils.flop_counter import flop_registry
    names = {getattr(p, "__name__", None) for p in flop_registry}
    return sum(v for k, v in cost.flops_by_label.items()
               if k.rsplit("/", 1)[1] in names)


def test_matmul_flops_equal_flop_counter():
    cfg = reduced(get_config("qwen2-1.5b"))
    _, tr = dryrun.trace_cell(cfg, TRAIN, None, num_microbatches=2,
                              unroll=True)
    assert tr.torch_flops > 0
    assert _matmul_flops(tr.cost) == tr.torch_flops


def test_train_flops_against_hlo_cost_of_the_reference_step():
    """Total FLOPs of the reduced qwen2-1.5b train step (S 32, B 4, 1 and
    2 microbatches): the trace against ``hlo_cost`` of the reference's
    ``build_train_step`` jitted on a one-device mesh. Measured: 1
    microbatch 79,554,651 against 80,755,651 (0.9851), 2 microbatches
    80,017,634 against 81,118,505 (0.9864); the trace counts each eager
    op (XLA fuses, folds and rewrites some elementwise work), so the
    tolerance is 2%."""
    from jax.sharding import Mesh as JMesh
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import reduced as jax_reduced
    from repro.launch import steps as jsteps
    cfg = reduced(get_config("qwen2-1.5b"))
    jcfg = jax_reduced(jax_get_config("qwen2-1.5b"))
    jmesh = JMesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    for m in (1, 2):
        built = jsteps.build_train_step(jcfg, JShape("t", 32, 4, "train"),
                                        jmesh, num_microbatches=m)
        ref = hlo_cost.module_cost(
            built.jitted.lower(*built.args).compile().as_text())
        _, tr = dryrun.trace_cell(cfg, TRAIN, None, num_microbatches=m)
        assert tr.cost.flops == pytest.approx(ref.flops, rel=0.02), m


def test_every_traced_tensor_is_fake_and_kernels_refuse():
    from torch._subclasses.fake_tensor import is_fake
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels.flash_attention import flash_attention

    class Spy(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.made = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.made += [t for t in trace_cost._tensors(out)]
            return out

    cfg = reduced(get_config("qwen2-1.5b"))
    from repro_torch.launch import steps
    built = steps.build_step(cfg, ShapeConfig("p", 16, 2, "prefill"))
    spy = Spy()

    def spied(*args):
        with spy:
            return built.fn(*args)

    tr = trace_cost.trace(spied, lambda: dryrun._fake_args(built, None))
    assert len(spy.made) > 100
    assert all(is_fake(t) for t in spy.made)
    assert all(is_fake(t) for t in trace_cost._tensors(tr.outputs))
    with pytest.raises(RuntimeError, match="dry-run trace"):
        _trace(lambda q: flash_attention(q, q, q), (1, 2, 8, 16))
