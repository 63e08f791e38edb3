"""The yardstick's work counts against hand counts at CSM-1B's shapes."""

import json

from benchmark.harness import work
from benchmark.harness.peaks import peak_of
from conftest import BENCH

CFG = json.loads((BENCH / "configs" / "csm-1b-int8.json").read_text())


def test_trunk_parameters():
    # backbone layer: qkv 2048x(32+16)*64, o 2048x2048, w13 2048x16384, w2 8192x2048
    per_layer = 2048 * 3072 + 2048 * 2048 + 2048 * 16384 + 8192 * 2048
    assert work.trunk_params(CFG["backbone"]) == 16 * per_layer == 973_078_528
    # decoder layer: qkv 1024x(8+4)*128, o 1024x1024, w13 1024x16384, w2 8192x1024
    assert work.trunk_params(CFG["decoder"]) == 4 * (1024 * 1536 + 1024 * 1024 + 1024 * 16384
                                                    + 8192 * 1024)


def test_quantized_products_of_a_frame_step():
    # int8 at S = 16: the backbone's weights once, the decoder's 32 times, one
    # f32 scale a column, x and y in bf16
    bb, dec = 973_078_528, 111_149_056
    cols_bb = 16 * (3072 + 2048 + 16384 + 2048)
    cols_dec = 4 * (1536 + 1024 + 16384 + 1024)
    rows_bb = 16 * (2048 + 2048 + 2048 + 8192)
    rows_dec = 4 * (1024 + 1024 + 1024 + 8192)
    want = (bb + 4 * cols_bb + 2 * 16 * (rows_bb + cols_bb)
            + 32 * (dec + 4 * cols_dec + 2 * 16 * (rows_dec + cols_dec)))
    nbytes, flops = work.quant_work(CFG, 16, 8)
    assert nbytes == want
    assert flops == 2 * 16 * (bb + 32 * dec)
    b4, f4 = work.quant_work(CFG, 16, 4, groups=2)
    assert b4 == want - (bb + 32 * dec) / 2 + 4 * (cols_bb + 32 * cols_dec) and f4 == flops
    parts = [work.quant_work(CFG, 16, 8, part=p) for p in ("backbone", "decoder")]
    assert sum(p[0] for p in parts) == nbytes
    # memory-bound on an H100 SXM: 4.69 GB at 3.35 TB/s
    assert abs(work.bound_s(nbytes, flops, peak_of("NVIDIA H100 80GB HBM3")) - nbytes / 3.35e12) < 1e-12


def test_attention_of_a_frame_step():
    # one row over 600 cached rows: 16 layers x (k and v: 8 heads x 600 x 64 x 2 B each,
    # q and out: 32 heads x 64 x 2 B each); decoder passes over 1..32 rows
    nb, fl = work.attention_work(CFG, [600], "backbone")
    assert nb == 16 * 2 * (2 * 8 * 600 * 64 + 2 * 32 * 64)
    assert fl == 16 * 4 * 32 * 64 * 600
    nd, fd = work.attention_work(CFG, [600], "decoder")
    assert nd == sum(4 * 2 * (2 * 2 * m * 128 + 2 * 8 * 128) for m in range(1, 33))
    assert work.attention_work(CFG, [600, 600]) == (2 * (nb + nd), 2 * (fl + fd))


def test_model_operations_of_a_frame_and_a_prefill():
    frame = work.frame_flops(CFG, 400)
    bb, dec = 973_078_528, 111_149_056
    heads = 2 * 2048 * 2051 + 31 * 2 * 1024 * 2051
    attn = 16 * 4 * 32 * 64 * 400 + sum(4 * 4 * 8 * 128 * m for m in range(1, 33))
    assert frame == 2 * bb + 32 * (2 * dec + 2 * 2048 * 1024) + heads + attn
    assert 9.2e9 < frame < 9.6e9  # ~9.4 GFLOP a frame-row
    pre = work.prefill_flops(CFG, 80, 200)
    visible = 80 * 200 + 80 * 81 // 2
    assert pre == 2 * bb * 80 + 16 * 4 * 32 * 64 * visible + work.sample_flops(CFG)
