"""Port parity: ``repro_torch.core.perfmodel`` against
``repro.core.perfmodel``.

``DpuModel`` and ``DpuSystemModel`` are the paper's UPMEM models, copied
verbatim: every figure the reference's tests check (tests/test_perfmodel.py)
is equal here, exactly, and still within the reference's tolerances of the
paper.  ``GpuModel`` replaces the TPU model: it carries the H100 SXM data
sheet's peaks and no constant of the reference's ``TpuModel``, and
``RooflineTerms`` keeps the reference's fields, terms and row keys over it.
"""
import dataclasses

import pytest

from repro.core import perfmodel as jpm
from repro_torch.core import perfmodel as tpm

M = tpm.DpuModel()

FIG4 = [
    ("add", "int32", 58.56), ("sub", "int32", 58.56),
    ("add", "int64", 50.16), ("mul", "int32", 10.27),
    ("div", "int32", 11.27), ("mul", "int64", 2.56), ("div", "int64", 1.40),
    ("add", "float", 4.91), ("sub", "float", 4.59), ("mul", "float", 1.91),
    ("div", "float", 0.34), ("add", "double", 3.32), ("sub", "double", 3.11),
    ("mul", "double", 0.53), ("div", "double", 0.16),
]


@pytest.mark.parametrize("op,dtype,paper_mops", FIG4)
def test_fig4_arith_throughput(op, dtype, paper_mops):
    got = M.arith_throughput(op, dtype, tasklets=16)
    assert got == jpm.DpuModel().arith_throughput(op, dtype, tasklets=16)
    assert got / 1e6 == pytest.approx(paper_mops, rel=0.35), (op, dtype)


@pytest.mark.parametrize("which,paper_mbps", [
    ("copy", 2818.98), ("add", 1682.46), ("scale", 42.03), ("triad", 61.66)])
def test_fig5_wram_stream(which, paper_mbps):
    got = M.wram_stream(which, tasklets=16)
    assert got == jpm.DpuModel().wram_stream(which, tasklets=16)
    assert got / 1e6 == pytest.approx(paper_mbps, rel=0.15), which


def test_fig6_mram_model_and_fit():
    assert M.mram_peak_bandwidth == pytest.approx(700e6)
    assert M.mram_bandwidth(2048) / 1e6 == pytest.approx(628.23, rel=0.05)
    sizes = [8, 32, 128, 512, 2048]
    cycles = [M.mram_latency_cycles(s) for s in sizes]
    assert tpm.DpuModel.fit_dma(sizes, cycles) == \
        jpm.DpuModel.fit_dma(sizes, cycles)


def test_system_model_is_the_reference():
    t, j = tpm.DpuSystemModel(), jpm.DpuSystemModel()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.aggregate_mram_bw == j.aggregate_mram_bw
    assert t.peak_gops == j.peak_gops


def test_system_aggregates():
    sys_ = tpm.DpuSystemModel()
    # paper §3.2.2: 1.7 TB/s theoretical aggregate for 2,556 DPUs
    assert sys_.n_dpus * sys_.dpu.mram_peak_bandwidth == \
        pytest.approx(1.79e12, rel=0.01)
    # Fig. 10: parallel beats serial by >10x at a full rank
    assert sys_.transfer_time(1 << 30, "parallel") * 10 < \
        sys_.transfer_time(1 << 30, "serial")


@pytest.mark.parametrize("kind", ["serial", "parallel", "parallel_from",
                                  "broadcast"])
@pytest.mark.parametrize("n_dpus", [None, 1, 64, 640])
def test_system_transfer_time_matches(kind, n_dpus):
    assert tpm.DpuSystemModel().transfer_time(1 << 24, kind, n_dpus) == \
        jpm.DpuSystemModel().transfer_time(1 << 24, kind, n_dpus)


def test_system_transfer_time_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        tpm.DpuSystemModel().transfer_time(1, "sideways")


def test_gpu_model_holds_no_tpu_constant():
    """The H100 SXM data sheet's peaks, and none of the TPU model's."""
    g = tpm.GpuModel()
    tpu = set(dataclasses.asdict(jpm.TpuModel()).values())
    assert not set(dataclasses.asdict(g).values()) & tpu
    assert (g.hbm_bw, g.peak_flops_f32, g.peak_flops_bf16) == (
        3.35e12, 67e12, 989e12)
    assert g.ridge_point == pytest.approx(989e12 / 3.35e12)
    assert not hasattr(tpm, "TpuModel")


def test_gpu_model_from_measured_stream_rows():
    rows = [{"stream": "copy", "mbps": 2.5e6, "seconds": 1.0},
            {"stream": "add", "mbps": 2.9e6, "seconds": 1.0}]
    g = tpm.GpuModel.from_stream_rows(rows)
    assert g.hbm_bw == pytest.approx(2.9e12)
    assert g.peak_flops_bf16 == tpm.GpuModel().peak_flops_bf16
    with pytest.raises(ValueError):
        tpm.GpuModel.from_stream_rows([])


def test_roofline_terms_over_the_gpu_model():
    g = tpm.GpuModel()
    t = tpm.RooflineTerms(flops=g.peak_flops_bf16 * 4, hbm_bytes=g.hbm_bw * 4,
                          collective_bytes=g.link_bw * 2, chips=4,
                          model_flops=g.peak_flops_bf16 * 4)
    assert t.t_compute == pytest.approx(1.0)
    assert t.t_memory == pytest.approx(1.0)
    assert t.t_collective == pytest.approx(0.5)
    assert t.bound in ("compute", "memory")
    assert t.roofline_fraction == pytest.approx(1.0)
    j = jpm.RooflineTerms(flops=1.0, hbm_bytes=1.0, collective_bytes=1.0,
                          chips=1)
    assert list(t.row()) == list(j.row())
    assert [f.name for f in dataclasses.fields(t)][:6] == \
        [f.name for f in dataclasses.fields(j)][:6]


def test_model_flops_and_min_bytes_match():
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    for arch in ("tinyllama-1.1b", "deepseek-moe-16b"):
        jc, tc = jget(arch), tget(arch)
        assert tpm.min_hbm_bytes_train(tc, 4096) == \
            jpm.min_hbm_bytes_train(jc, 4096)
        assert tpm.min_hbm_bytes_decode(tc, 8, 1e9) == \
            jpm.min_hbm_bytes_decode(jc, 8, 1e9)
        assert tpm.min_hbm_bytes_prefill(tc, 2048) == \
            jpm.min_hbm_bytes_prefill(jc, 2048)
    assert tpm.model_flops_train(1e9, 1e6) == jpm.model_flops_train(1e9, 1e6)
    assert tpm.model_flops_decode(1e9, 8) == jpm.model_flops_decode(1e9, 8)
