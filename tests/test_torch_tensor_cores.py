"""The host side of the port's tensor-core stage chain, on the CPU: the
three-plane split of float32 weights, which packed weights carry the
planes, the static rule that picks the chain and the shared-memory planner
of the stage kernels. The kernels themselves run only on a card
(`tests/test_torch_cuda.py`).

Tolerances: none where the property is exact (the split); the
split of values below 2^-110 in magnitude is held to bf16's smallest
subnormal, 2^-133, the most it can lose there.
"""

import numpy as np
import pytest
import torch

from nsc_tpu_torch.configs import get_config
from nsc_tpu_torch.kernels import fused_stage as FS
from nsc_tpu_torch.kernels import residual_stack as RS
from nsc_tpu_torch.models import seanet as PS
from torch_stage_shapes import PLANNER_REJECTS, SHIPPED, stage_shapes

def _bits(*words):
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.float32))


EXACT_EDGES = torch.cat([
    torch.tensor([0.0, -0.0, 1e30, -1e30, 1e-30, -1e-30, 1.0, -3.0]),
    _bits(0x00800000, 0x80800000,  # the smallest normals (bf16 values)
          0x00810000,              # near them, low 16 bits clear
          0x08FFFFFF, 0x88FFFFFF,  # 2^-110 with every mantissa bit set
          0x3F800001, 0x3F7FFFFF, 0xBF800101,  # low mantissa bits set
          0x7F7FFFFF, 0xFF7FFFFF),  # the largest finite values
])
TINY_EDGES = _bits(0x00800001, 0x80FFFFFF, 0x00C0FFFF, 0x087FFFFF)  # |w| < 2^-110


def _planes_sum(planes):
    p = planes.float()
    return (p[0] + p[1]) + p[2]


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_split_planes_is_exact_on_random_weights(scale):
    w = torch.from_numpy(np.random.RandomState(0).randn(3, 64, 48).astype(np.float32)) * scale
    planes = RS.split_planes(w)
    assert planes.dtype == torch.bfloat16 and planes.shape == (3, *w.shape)
    assert torch.equal(_planes_sum(planes), w)
    # truncation: hi and mid keep w's sign, and each plane is far below the last
    assert torch.all(planes[1].float().abs() <= planes[0].float().abs() * 2.0**-7)
    assert torch.all(planes[2].float().abs() <= planes[1].float().abs() * 2.0**-7)


def test_split_planes_edge_values():
    planes = RS.split_planes(EXACT_EDGES)
    assert torch.isfinite(planes.float()).all()
    assert torch.equal(_planes_sum(planes), EXACT_EDGES)
    # each plane is a bf16 value: a round trip through float32 keeps it
    assert torch.equal(planes.float().to(torch.bfloat16), planes)
    tiny = RS.split_planes(TINY_EDGES)
    assert ((_planes_sum(tiny) - TINY_EDGES).abs() <= 2.0**-133).all()


def test_three_plane_products_equal_float32_weight_products():
    """bf16 activations times the planes, summed in float64, equal the
    activations times the float32 weights: every product is exact."""
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(40, 96).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(96, 32).astype(np.float32))
    planes = RS.split_planes(w).double()
    by_planes = sum(a.double() @ planes[i] for i in range(3))
    assert torch.equal(by_planes, a.double() @ w.double())


def _stage(c, c_prev, c_next, s_down, s_up, seed):
    g = torch.Generator().manual_seed(seed)
    units = [{"conv1": {"w": torch.randn(c, c, 3, generator=g), "b": torch.randn(c, generator=g)},
              "conv2": {"w": torch.randn(c, c, 1, generator=g), "b": torch.randn(c, generator=g)},
              "act1": torch.rand(c, generator=g) + 1, "act2": torch.rand(c, generator=g) + 1}
             for _ in range(3)]
    return {"units": units,
            "down_act": torch.rand(c, generator=g) + 1,
            "down": {"w": torch.randn(c_next, c, 2 * s_down, generator=g),
                     "b": torch.randn(c_next, generator=g)},
            "up_act": torch.rand(c_prev, generator=g) + 1,
            "up": {"w": torch.randn(c_prev, c, 2 * s_up, generator=g), "b": torch.randn(c, generator=g)}}


def _packed_units(route, dtype, fast):
    """The packed units of every stage of a small encoder and decoder (every
    width, head input and tail output a multiple of 16), beside the float32
    weights they were packed from."""
    enc = [_stage(16, 8, 32, 2, 2, 0), _stage(32, 16, 64, 4, 2, 1)]
    dec = [_stage(32, 64, 16, 4, 4, 2), _stage(16, 32, 8, 2, 4, 3)]
    PS.pack_stages("encoder", enc, route, dtype, fast)
    PS.pack_stages("decoder", dec, route, dtype, fast)
    key = {"residual_stack": "stack", "residual_stack_cl": "stack_cl", "fused_stage": "fused"}[route]
    for st in enc + dec:
        w1 = torch.stack([u["conv1"]["w"].permute(2, 1, 0) for u in st["units"]])
        w2 = torch.stack([u["conv2"]["w"][:, :, 0].t() for u in st["units"]])
        yield (st[key]["units"] if route == "fused_stage" else st[key]), w1, w2


def _check_packed(route, dtype, fast):
    """K6's and K5's float32 unit weights are stored as bf16 planes where
    the run takes the tensor-core chain and as float32 elsewhere, never
    both; K1 never carries planes. Either form gives back the weights."""
    want = route != "residual_stack" and dtype == torch.bfloat16 and fast
    for units, w1, w2 in _packed_units(route, dtype, fast):
        assert ("w1p" in units and "w2p" in units) == want
        assert ("w1" in units and "w2" in units) != want
        if route == "residual_stack":
            w1, w2 = w1.to(dtype), w2.to(dtype)
        got1, got2 = RS.unit_weights(units)
        assert torch.equal(got1, w1.float()) and torch.equal(got2, w2.float())
        if want:
            u, c = w2.shape[:2]
            assert units["w1p"].shape == (3, u, 3, c, c) and units["w2p"].shape == (3, u, c, c)


@pytest.mark.parametrize("route", ["residual_stack", "residual_stack_cl", "fused_stage"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_weights_carry_planes_only_on_k5_and_k6_bf16_routes(route, dtype):
    _check_packed(route, dtype, fast=True)


@pytest.mark.parametrize("route", ["residual_stack", "residual_stack_cl", "fused_stage"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_weights_with_snake_carry_no_planes(route, dtype):
    """snake (not snake_fast) runs the SIMT chain in every dtype."""
    _check_packed(route, dtype, fast=False)


def test_pack_stage_refuses_planes_of_bf16_weights():
    with pytest.raises(ValueError):
        RS.pack_stage(_stage(16, 8, 32, 2, 2, 0)["units"], torch.bfloat16, planes=True)


@pytest.mark.parametrize("dtype,fast,widths,want", [
    (torch.bfloat16, True, (32,), True), (torch.bfloat16, True, (16,), True),
    (torch.bfloat16, True, (256,), True), (torch.bfloat16, True, (48, 16), True),
    (torch.bfloat16, True, (40,), False), (torch.bfloat16, True, (12,), False),
    (torch.bfloat16, True, (272,), False), (torch.bfloat16, True, (64, 8), False),
    (torch.bfloat16, False, (64,), False), (torch.float32, True, (64,), False),
])
def test_tensor_core_rule(dtype, fast, widths, want):
    assert RS.tensor_cores(dtype, fast, *widths) is want


def test_fused_rule_needs_a_head_width_of_16():
    bf = torch.bfloat16
    assert FS.tensor_cores(bf, True, 32, 64, 64, 2, 0)
    assert not FS.tensor_cores(bf, True, 24, 64, 64, 2, 0)
    assert FS.tensor_cores(bf, True, 48, 48, 48, 0, 0)
    assert not FS.tensor_cores(bf, True, 64, 64, 40, 0, 4)


@pytest.mark.parametrize("name", SHIPPED)
def test_planner_accepts_every_shipped_stage(name):
    cfg = get_config(name)
    halo = sum(2 * d for d in cfg.dilations)
    for c_in, c, c_out, sh, stl in stage_shapes(cfg):
        for dtype in (torch.float32, torch.bfloat16):
            for fast in (True, False):
                for planes in (1, 3):
                    tile, nbytes = RS.stack_plan(c, halo, dtype, fast, planes)
                    assert tile >= 32 and nbytes <= RS.MAX_SMEM, (name, c, dtype, fast, planes)
                tile, nbytes = FS.stage_plan(c_in, c, c_out, sh, stl, halo, dtype, fast)
                assert tile >= 32 and nbytes <= RS.MAX_SMEM, (name, c_in, c, c_out, dtype, fast)


def test_planner_tensor_core_budget_at_base_fast():
    """bf16 serving at base_fast's widest stage: the time-major bf16 buffers
    and the three-plane weight stages fit, one block per SM."""
    tile, nbytes = RS.stack_plan(256, 26, torch.bfloat16, True, 3)
    assert nbytes == 2 * 2 * 256 * (tile + 26) + 2 * 3 * 16 * 264 * 2 + 6 * 4 * 256
    assert 32 <= tile and nbytes <= RS.MAX_SMEM
    tile1, _ = RS.stack_plan(256, 26, torch.bfloat16, True, 1)
    assert tile1 >= tile  # one plane, smaller weight stages


@pytest.mark.parametrize("args", PLANNER_REJECTS)
def test_planner_rejects_what_exceeds_227_kb(args):
    kind, a = args
    tile, _ = RS.stack_plan(*a) if kind == "stack" else FS.stage_plan(*a)
    assert tile == 0
    with pytest.raises(ValueError, match="shared memory"):
        RS.check_plan(tile, "stage")

