'''The conv chain kernels' launch geometry, computed on the CPU.

The wrappers pick each launch's channel group, tile, block size and (for
the backward) persistent grid and scratch in pure Python
(ops/kernels/conv_chain.py: plan, conv_chain_bwd.py: plan): one rule, and a
TUNED table where a sweep on the card measured the rule slower; the CUDA
kernels trust it. These tests hold the plans at the six unet.yaml chain
sites (B=8 training, B=64 prediction) and at the edge shapes of
test_torch_gpu.py to what the kernels need: shared memory within the
card's limit, row widths that fit the float4 window reads, at least one
block per SM at the training batch (where tiles of 4 x 64 give that many),
the two-launch backward at the sites and scratch sized for the partial
sums.
'''

import pytest

from dnncancerannotator_torch.ops.kernels import _build
from dnncancerannotator_torch.ops.kernels import conv_chain as CC
from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB

# (Ci, Cm, Co, H = W) of unet.yaml's ConvChains at 256 x 256 crops
SITES = {'down_0': (5, 3, 3, 256), 'down_1': (3, 6, 6, 128),
         'down_2': (6, 12, 12, 64), 'up_0': (24, 12, 12, 64),
         'up_1': (12, 6, 6, 128), 'up_2': (6, 3, 3, 256)}
# (B, Ci, Cm, Co, H, W, K) of test_torch_gpu.py's edge cases
EDGES = [(2, 5, 3, 3, 37, 70, 3), (2, 24, 12, 12, 16, 16, 3),
         (2, 32, 32, 32, 9, 33, 3), (2, 4, 5, 6, 20, 20, 5),
         (2, 12, 6, 6, 33, 20, 3), (2, 32, 32, 32, 9, 9, 3)]
CASES = ([(b, site) for site in SITES for b in (8, 64)]
         + [(None, edge) for edge in EDGES])


def _shape(b, case):
    if b is None:
        return case
    ci, cm, co, hw = SITES[case]
    return (b, ci, cm, co, hw, hw, 3)


def _filled(b, h, w):
    '''The blocks a training site launches at least: one an SM, unless
    that takes tiles under 4 x 64, which measured slower on the H100 at
    down_2 and up_0 (64 x 64, B=8: 128 tiles of 4 x 64; PERF.md).'''
    return min(CC.SMS, b * CC.cdiv(h, 4) * CC.cdiv(w, 64))


def _check_rows(pl, k, row_w):
    px = CC.run_px(pl.cpt)
    p = k // 2
    assert pl.threads % 32 == 0 and pl.threads <= 256
    assert pl.tile_w % px == 0
    assert pl.c1_w % px == 0 and pl.c1_w >= pl.tile_w + 2 * p
    # the float4 window reads of the last run stay inside a row
    assert pl.c1_w >= pl.tile_w - px + 4 * CC.cdiv(px + k - 1, 4)
    # row strides 4 mod 8 floats: conflict-free float4 loads down rows
    assert pl.c1_s >= pl.c1_w and pl.c1_s % 8 == 4
    assert row_w % 8 == 4 and row_w >= pl.c1_w + max(2 * p, 4)
    assert pl.smem <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize('b,case', CASES)
def test_forward_plan(b, case):
    b, ci, cm, co, h, w, k = _shape(b, case)
    pl = CC.plan(b, ci, cm, co, h, w, k)
    assert pl.cpt in CC.cpt_choices(cm, co)
    _check_rows(pl, k, pl.xs_w)
    assert pl.smem == CC._smem_bytes(ci, cm, co, k, pl.cpt, pl.tile_h,
                                     pl.c1_s, pl.xs_w)
    assert pl.blocks == b * CC.cdiv(h, pl.tile_h) * CC.cdiv(w, pl.tile_w)
    if b == 8:
        assert pl.blocks >= _filled(b, h, w)
    if case in SITES:   # no padding at the sites
        assert cm % pl.cpt == 0 and co % pl.cpt == 0


@pytest.mark.parametrize('b,case', CASES)
@pytest.mark.parametrize('need_dx', [False, True])
def test_backward_plan(b, case, need_dx):
    b, ci, cm, co, h, w, k = _shape(b, case)
    pl = CCB.plan(b, ci, cm, co, h, w, k, need_dx)
    _check_rows(pl, k, pl.gs_w)
    n = CCB.n_out(ci, cm, co, k)
    tiles = b * CC.cdiv(h, pl.tile_h) * CC.cdiv(w, pl.tile_w)
    assert 1 <= pl.blocks <= tiles
    if k == 3 and max(ci, cm, co) < 32:
        assert pl.fused   # the sites and the narrow edges: two launches
    if pl.fused:
        assert k == 3 and pl.cpt in CCB.FUSED_CPT
        items = CCB.wgrad_items(ci, cm, co, pl.cpt)
        assert pl.slices == pl.threads // items >= 1
        # one row of weight-gradient sums a thread fits the block
        assert pl.smem >= 4 * pl.threads * pl.cpt * k * k
        assert pl.scratch_floats == n * pl.blocks   # the partials
    else:
        assert pl.cpt in CCB.DGRAD_CPT and pl.wgrad_blocks >= 1
        rows = max(cm * ci * k * k + cm, co * cm * k * k + co)
        assert pl.scratch_floats == rows * pl.wgrad_blocks + b * cm * h * w
    assert pl.smem == CCB._smem_bytes(ci, cm, co, k, pl.cpt, pl.tile_h,
                                      pl.c1_s, pl.gs_w, need_dx, pl.fused,
                                      pl.threads)
    if b == 8:
        assert pl.blocks >= _filled(b, h, w)


def test_supported_shapes_have_plans():
    '''Every shape the wrappers' ``supported`` takes (what routes the
    model to the kernels) has a plan, and a shape past it has none.'''
    for ci, cm, co, _ in SITES.values():
        assert CC.supported(ci, cm, co, 3) and CCB.supported(ci, cm, co, 3)
    assert not CC.supported(33, 4, 4, 3) and not CCB.supported(4, 4, 33, 3)
    for k in (1, 3, 5, 7):
        for ci in (1, 5, 12, 32):
            for cm in (1, 5, 12, 32):
                for co in (1, 6, 32):
                    shape = (1, ci, cm, co, 3, 3, k)
                    assert CC.supported(ci, cm, co, k) == (
                        CC.plan(*shape) is not None), shape
                    if CCB.supported(ci, cm, co, k):
                        assert CCB.plan(*shape, True) is not None, shape


@pytest.mark.parametrize('table', ['forward', 'backward'])
def test_tuned_plans_override_the_rule(table):
    '''Every TUNED plan is at a shape of the six sites, fits shared memory,
    takes the rule's kernel and channel group and differs from the rule's
    plan; elsewhere ``plan`` is the rule's.'''
    module = CC if table == 'forward' else CCB
    sites = {(ci, cm, co, hw, hw, 3) for ci, cm, co, hw in SITES.values()}
    for key, geometry in module.TUNED.items():
        assert key[1:7] in sites
        pl, ruled = module.plan(*key), module.rule(*key)
        assert (pl.cpt, pl.tile_h, pl.tile_w, pl.threads) == geometry
        assert pl.smem <= _build.MAX_SMEM_BYTES
        assert pl.cpt == ruled.cpt and pl != ruled
        if table == 'backward':
            assert pl.fused and ruled.fused
    for b, case in CASES:
        shape = _shape(b, case)
        if table == 'backward':
            shape += (case != 'down_0',)
        if shape not in module.TUNED:
            assert module.plan(*shape) == module.rule(*shape)
