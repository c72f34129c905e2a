"""The operations and bytes of each kernel and model, from shapes alone,
against counts worked out by hand at small shapes (the causal mask and
the window included), and the same whichever body the program runs."""

import pytest

import tiny  # noqa: F401
from bench import harness
from bench.roofline import (flash_attention as fa, flash_attention_bwd as
                            fab, model_dense, peaks, rwkv6_scan as rs,
                            rwkv6_scan_bwd as rsb)


def _call(**kw):
    c = {"B": 1, "H": 1, "KV": 1, "Tq": 4, "Tk": 4, "hd": 2, "hdv": 2,
         "causal": True, "window": None, "q_bytes": 2, "kv_bytes": 2}
    c.update(kw)
    return c


@pytest.mark.parametrize("Tq,Tk,causal,window,pairs,keys", [
    (4, 4, True, None, 10, 4),        # 1 + 2 + 3 + 4
    (4, 4, False, None, 16, 4),
    (4, 4, True, 2, 7, 4),            # 1 + 2 + 2 + 2
    (5, 5, True, 1, 5, 5),            # the diagonal alone
    (2, 6, True, None, 11, 6),        # queries at the tail: 5 + 6
    (2, 6, True, 3, 6, 4),            # keys 2..5: 3 + 3
    (1, 8, True, 4, 4, 4),            # one decode query over its window
])
def test_visible_pairs_by_hand(Tq, Tk, causal, window, pairs, keys):
    assert fa.visible(Tq, Tk, causal, window) == (pairs, keys)


def test_flash_forward_by_hand():
    c = _call(B=2, H=4, KV=2, hd=8, hdv=8, window=2)
    # 7 pairs a head: q.k and p.v, 8 multiply-adds each
    assert fa.flops(c) == 2 * (8 + 8) * 2 * 4 * 7
    # q + out: 2 x 4 x 4 rows of 16 values; k + v: 2 x 2 x 4 rows of 16
    assert fa.nbytes(c) == 2 * 4 * 4 * 16 * 2 + 2 * 2 * 4 * 16 * 2
    c32 = dict(c, kv_bytes=4)
    assert fa.nbytes(c32) - fa.nbytes(c) == 2 * 2 * 4 * 16 * 2


def test_flash_backward_by_hand():
    c = _call(B=1, H=2, KV=1, hd=4, hdv=4)
    # 10 pairs a head; S, dV, dP, dQ, dK: 3 hd + 2 hdv = 20 a pair
    assert fab.flops(c) == 2 * 20 * 2 * 10
    rows_q, rows_k = 1 * 2 * 4, 1 * 1 * 4
    # q, o, dO in and dq out (4 x 4 values a row); k, v in, dk, dv out;
    # the fp32 log-sum-exp
    assert fab.nbytes(c) == rows_q * 16 * 2 + 2 * rows_k * 8 * 2 + rows_q * 4


def test_scan_by_hand():
    c = {"B": 1, "H": 2, "T": 3, "K": 4, "V": 4, "state": False,
         "io_bytes": 2}
    assert rs.flops(c) == 2 * 3 * (5 * 16 + 3 * 4 + 2 * 4)
    # r, k, v, y (16 values a token and head, bf16), w fp32, u fp32,
    # the final state fp32
    assert rs.nbytes(c) == 6 * 16 * 2 + 6 * 4 * 4 + 2 * 4 * 4 + 2 * 16 * 4
    assert rs.nbytes(dict(c, state=True)) - rs.nbytes(c) == 2 * 16 * 4
    assert rsb.flops(c) == 6 * (14 * 16 + 15 * 4 + 4 * 4)
    # in: r, k, v, dy; w; u. out: dr, dk, dv; dw; du
    assert rsb.nbytes(c) == (6 * 16 * 2 + 6 * 4 * 4 + 8 * 4
                             + 6 * 12 * 2 + 6 * 4 * 4 + 8 * 4)


def test_least_time_is_the_larger_bound():
    assert peaks.least_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert peaks.least_s(0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert peaks.least_s(67e12, 1.0, "float32") == pytest.approx(1.0)


def _cfg(name):
    bench = harness.benchmark()
    conf = {c["name"]: c for c in bench["configs"]}[name]
    return harness.load_json(harness.ROOT / conf["file"])


def test_calls_follow_the_work_not_the_body():
    cfg = _cfg("h2o-danube-1.8b")
    train = {"phase": "train", "rows": 4, "seq": 2048, "microbatch": 1,
             "units": 2}
    (c, n), = fab.calls(cfg, train)
    assert n == 24 * 2 and c["B"] == 4 and c["Tq"] == 2048
    # the body's name (wgmma or CUDA cores) is nowhere in the count
    assert "body" not in c
    assert fab.least_s(c, "bfloat16") == pytest.approx(
        2 * 400 * 4 * 32 * 2048 * 2049 / 2 / 989e12)
    (p, n), = fa.calls(cfg, {"phase": "prefill", "rows": 16, "seq": 3000})
    assert n == 24 and p["kv_bytes"] == 4 and p["B"] == 16
    rcfg = {"hidden_size": 2560, "head_dim": 64, "num_hidden_layers": 32,
            "torch_dtype": "bfloat16"}
    (s, n), = rsb.calls(rcfg, dict(train, microbatch=4))
    assert n == 32 * 4 * 2 and s["B"] == 1 and s["H"] == 40
    assert fab.calls(cfg, {"phase": "prefill", "rows": 1, "seq": 8}) == []


def test_model_flops_by_hand():
    cfg = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
           "vocab_size": 10, "num_hidden_layers": 3, "sliding_window": 2}
    layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 2 * 8 * 16 + 16 * 8
    assert model_dense.matmul_params(cfg) == 3 * layer + 8 * 10
    # 3 tokens, window 2: 1 + 2 + 2 pairs a head; q.k and p.v over 4
    assert model_dense.mixer_flops(cfg, 3) == 3 * 2 * 2 * 8 * 5
    assert model_dense.train_flops(cfg, 2, 3) == 3 * 2 * (
        2 * model_dense.matmul_params(cfg) * 3 + 3 * 2 * 2 * 8 * 5)


def test_published_sizes():
    assert model_dense.matmul_params(_cfg("h2o-danube-1.8b")) == \
        24 * 69468160 + 2560 * 32000
