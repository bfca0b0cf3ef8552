"""plslam_tpu_torch.roofline on the CPU: the dispatch counter's exact work
on known ops (an mm is 2MNK FLOPs, an elementwise op one per output
element, a view nothing; bytes unfused and per program), the three
kernels counted by their formulas and not by their plain twins' ops, the
formulas moved out of chip_smoke.py giving the values chip_smoke.py gave
before the move, and the program printing a finite row per stage at a
small size."""

import json
import math

import numpy as np
import pytest
import torch

from plslam_tpu_torch import roofline
from plslam_tpu_torch.ops import cuda_fast, cuda_hamming, cuda_patches

from test_torch_helpers import load_chip_smoke, one_torch_thread  # noqa: F401


def test_counter_matmul_and_elementwise_exact():
    g = torch.Generator().manual_seed(0)
    M, K, N = 5, 7, 3
    a, b = torch.rand((M, K), generator=g), torch.rand((K, N), generator=g)
    c = torch.rand((M, N), generator=g)
    (_, w_mm) = roofline.count_work(lambda: a @ b)
    assert w_mm.ops == {"f32": 2 * M * N * K}
    assert w_mm.unfused_bytes == 4 * (M * K + K * N + M * N)
    (_, w_add) = roofline.count_work(lambda: a @ b + c)
    assert w_add.ops == {"f32": 2 * M * N * K + M * N}
    assert w_add.unfused_bytes == w_mm.unfused_bytes + 4 * 3 * M * N
    # batched product: bmm's 2BMNK
    x, y = torch.rand((4, M, K), generator=g), torch.rand((4, K, N), generator=g)
    (_, w_bmm) = roofline.count_work(lambda: torch.bmm(x, y))
    assert w_bmm.ops == {"f32": 2 * 4 * M * N * K}


def test_counter_views_and_broadcasts():
    g = torch.Generator().manual_seed(1)
    a = torch.rand((6, 4), generator=g)
    (_, w) = roofline.count_work(lambda: a.t().reshape(-1)[::2])
    # a transpose and a contiguous reshape are views; the reshape of the
    # transpose copies (24 elements), the stride-2 slice is a view
    assert w.ops == {"f32": 24}
    assert w.unfused_bytes == 2 * 24 * 4
    row = torch.rand((1, 4), generator=g)
    (_, w) = roofline.count_work(lambda: a * row.expand(6, 4))
    # the expanded operand holds 4 distinct elements
    assert w.ops == {"f32": 24}
    assert w.unfused_bytes == 4 * (24 + 4 + 24)


def test_program_bytes_count_inputs_and_outputs_once():
    a = torch.zeros((3, 5))
    tree = (a, {"x": torch.zeros(4, dtype=torch.int64)}, None, [a.expand(2, 3, 5)])
    assert roofline.tree_bytes(tree) == 60 + 32 + 60


def test_kernels_counted_by_their_formulas():
    g = torch.Generator().manual_seed(2)
    imgs = torch.rand((2, 40, 56), generator=g) * 255
    thr = torch.full((2,), 20.0)
    (raw_nms, w) = roofline.count_work(lambda: cuda_fast.fast_score_nms_batch(imgs, thr))
    adds, minmax = roofline.fast_op_counts(imgs, thr)
    assert w.ops == {"f32": 0.0, "f32_add": adds, "f32_minmax": minmax}
    assert w.unfused_bytes == 12 * imgs.numel() + 8
    assert w.kernels["fast_score_nms_batch"]["calls"] == 1
    want = cuda_fast.fast_score_nms_plain(imgs, thr)
    assert all(torch.equal(x, y) for x, y in zip(raw_nms, want))

    y0 = torch.randint(-4, 40, (2, 9), generator=g, dtype=torch.int32)
    x0 = torch.randint(-4, 56, (2, 9), generator=g, dtype=torch.int32)
    (_, w) = roofline.count_work(lambda: cuda_patches.gather_patches_batch(imgs, y0, x0, 8))
    assert w.ops == {"f32": 0.0}
    assert w.unfused_bytes == imgs.numel() * 4 + 2 * 18 * 4 + 18 * 64 * 4

    d1 = torch.randint(-2**31, 2**31, (7, 8), generator=g, dtype=torch.int64).to(torch.int32)
    d2 = torch.randint(-2**31, 2**31, (5, 8), generator=g, dtype=torch.int64).to(torch.int32)
    # through the operator, as the matching code calls it: counted once
    (_, w) = roofline.count_work(lambda: cuda_hamming.hamming_distance_matrix(d1, d2))
    assert w.ops == {"f32": 0.0, "int8": 2.0 * 7 * 5 * 256}
    assert w.unfused_bytes == (7 + 5) * 32 + 7 * 5 * 4
    assert w.kernels == {"hamming_distance_matrix_cuda": {"calls": 1, "bytes": (7 + 5) * 32
                                                          + 7 * 5 * 4, "ops": 2.0 * 7 * 5 * 256}}


def test_moved_formulas_give_chip_smokes_values():
    """The values of chip_smoke.py's own ``bound`` and ``fast_ops`` on the
    parent commit (before they moved into the package), on seeded inputs."""
    chip_smoke = load_chip_smoke()
    assert chip_smoke.bound is roofline.bound and chip_smoke.fast_ops is roofline.fast_ops
    assert roofline.bound(2.0e6, (1.0e9, roofline.F32_OPS_PER_S)) == (
        0.014925373134328358, "operations")
    assert roofline.bound(5.0e8, (1.0e9, roofline.F32_OPS_PER_S)) == (
        0.14925373134328357, "bytes")
    g = torch.Generator().manual_seed(0)
    imgs = torch.rand((2, 120, 188), generator=g) * 255
    thr = torch.full((2,), 20.0)
    assert roofline.fast_ops(imgs, thr) == ((642024, 33500000000000.0),
                                            (5357334, 16750000000000.0))
    assert roofline.bound(roofline.fast_bytes(imgs, thr), *roofline.fast_ops(imgs, thr)) == (
        0.0003390057313432836, "operations")
    d = torch.zeros((1200, 8), dtype=torch.int32)
    nbytes, ops = roofline.hamming_work(d, d)
    assert roofline.bound(nbytes, (ops, roofline.INT8_OPS_PER_S)) == (
        0.0017423283582089551, "bytes")
    db = torch.zeros((16, 256, 8), dtype=torch.int32)
    nbytes, ops = roofline.hamming_work(db, db)
    assert roofline.bound(nbytes, (ops, roofline.INT8_OPS_PER_S)) == (
        0.0013302829850746268, "bytes")
    assert roofline.patches_bytes(torch.zeros((2, 480, 752)),
                                  torch.zeros((2, 1200), dtype=torch.int32), 48) == 25025280
    assert (roofline.HBM_BYTES_PER_S, roofline.INT8_OPS_PER_S, roofline.F32_OPS_PER_S,
            roofline.F32_ADD_PER_S, roofline.F32_MINMAX_PER_S) == (
        3.35e12, 1979e12, 67e12, 33.5e12, 16.75e12)


def test_unknown_card_has_no_peaks():
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.peaks("NVIDIA GeForce RTX 4090")
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["f32_minmax"] == 16.75e12


def test_main_on_the_cpu_prints_a_finite_row_per_program(capsys):
    assert roofline.main(["--device", "cpu", "--n", "2", "--scale", "0.25"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = json.loads(out[-1])["roofline"]
    assert [r["stage"] for r in rows][:3] == ["point detect+describe", "line detect+LBD",
                                              "match+f2f+GN track"]
    assert rows[3]["stage"].startswith("local BA (10 LM iters, 8KF/128pt/16ls)")
    for r in rows:
        for k in ("ms", "gflop", "mb_unfused", "mb_program", "gflop_s", "gb_s_unfused",
                  "gb_s_program"):
            assert math.isfinite(r[k]) and r[k] > 0, (r["stage"], k)
        assert r["mb_unfused"] > r["mb_program"]
        assert r["bits_equal"] and not r["graphed"]
    assert rows[2]["gop_int8"] > 0          # the Hamming matrices of the matching
    assert any(line.startswith("# per-frame host total (3 stages)") for line in out)
    assert np.isclose(json.loads(out[-1])["per_frame_ms"], sum(r["ms"] for r in rows[:3]))
