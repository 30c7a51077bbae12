"""``chip_smoke.py::build_gate``: what in ptxas' report fails the kernels'
build on the card. A serialised wgmma (ptxas' C75xx note) or a spill fails
it for any K1, K2 or K3 template instance (K3's cotangent chain and its
batch-wide weight gradients), float32 K1 (the CUDA-core parity body)
included. Fed canned ``-Xptxas -v`` lines of the kind an H100 build
prints; nothing here needs a card or nvcc."""

import pytest

from chip_smoke import build_gate

MANGLED = {
    "gnn_forward_kernel<float>":
        "_ZN47_GLOBAL__N__afbb3412_14_gnn_forward_cu_9670387218gnn_forward_kernelIfEEvNS_6ParamsE",
    "gnn_forward_kernel<bf16>":
        "_ZN47_GLOBAL__N__afbb3412_14_gnn_forward_cu_9670387218gnn_forward_kernelI13__nv_bfloat16"
        "EEvNS_6ParamsE",
    "gnn_train_bwd_kernel<float>":
        "_ZN49_GLOBAL__N__32d220ed_16_gnn_train_bwd_cu_49e3584420gnn_train_bwd_kernelIfEEvNS_6Par"
        "amsE",
    "gnn_train_bwd_kernel<bf16>":
        "_ZN49_GLOBAL__N__32d220ed_16_gnn_train_bwd_cu_49e3584420gnn_train_bwd_kernelI13__nv_bfl"
        "oat16EEvNS_6ParamsE",
    "wgrad_sum_samples_kernel<float>":
        "_ZN49_GLOBAL__N__32d220ed_16_gnn_train_bwd_cu_49e3584424wgrad_sum_samples_kernelIfEEvNS_"
        "8WgParamsE",
    "wgrad_sum_samples_kernel<bf16>":
        "_ZN49_GLOBAL__N__32d220ed_16_gnn_train_bwd_cu_49e3584424wgrad_sum_samples_kernelI13__nv_"
        "bfloat16EEvNS_8WgParamsE",
    "rollout_chunk_kernel<float>":
        "_ZN49_GLOBAL__N__5c1e0f2a_16_rollout_chunk_cu_7d2e1b3c20rollout_chunk_kernelIfEEvNS_6Pa"
        "ramsE",
    "rollout_chunk_kernel<bf16>":
        "_ZN49_GLOBAL__N__5c1e0f2a_16_rollout_chunk_cu_7d2e1b3c20rollout_chunk_kernelI13__nv_bfl"
        "oat16EEvNS_6ParamsE",
    "rollout_chunk_kernel_w160<bf16>":
        "_ZN49_GLOBAL__N__5c1e0f2a_16_rollout_chunk_cu_7d2e1b3c25rollout_chunk_kernel_w160I13__n"
        "v_bfloat16EEvNS_6ParamsE",
}
# a function of the same library that is no kernel instance (a noinline helper)
HELPER = "_ZN3gnnL6chain2EPK13__nv_bfloat16S2_iiRfS3_"


def properties(fn, stores=0, loads=0, registers=255):
    """ptxas' lines for one function: its entry, its properties, its registers."""
    return [f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'",
            f"ptxas info    : Function properties for {fn}",
            f"    24 bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads",
            f"ptxas info    : Used {registers} registers, used 1 barriers, 24 bytes cumulative "
            "stack size"]


def serialised(fn):
    return [f"ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions "
            f"are serialized due to program dependence on compiler-inserted WG.AR in divergent "
            f"path in the function '{fn}'"]


def injected(fn):  # an informational note that is no serialisation
    return [f"ptxas info    : (C7519) warpgroup.arrive is injected in around line 21233 by "
            f"compiler to allow use of registers in GMMA in function '{fn}'"]


def report(**change):
    """Every instance's lines, clean but for ``change`` (instance -> its lines)."""
    out = []
    for name, fn in MANGLED.items():
        out += change.get(name, properties(fn))
    return out + properties(HELPER, stores=64, loads=64, registers=40)


@pytest.mark.parametrize("instance", sorted(MANGLED))
@pytest.mark.parametrize("case", ["clean", "serialised", "spills"])
def test_build_gate(instance, case):
    fn = MANGLED[instance]
    lines = {"clean": injected(fn) + properties(fn),
             "serialised": serialised(fn) + properties(fn),
             "spills": properties(fn, stores=8, loads=16)}[case]
    got = build_gate(report(**{instance: lines}))
    if case == "clean":
        assert got == []
    elif case == "serialised":
        assert len(got) == 1 and got[0][0] == instance
        assert got[0][1].startswith("wgmma serialized: (C7520)")
    else:
        assert got == [(instance, "spills: 8 bytes stored, 16 bytes loaded")]


def test_build_gate_reads_every_instance_at_once():
    lines = report(**{"gnn_forward_kernel<bf16>": serialised(MANGLED["gnn_forward_kernel<bf16>"])
                      + properties(MANGLED["gnn_forward_kernel<bf16>"]),
                      "gnn_train_bwd_kernel<bf16>": properties(
                          MANGLED["gnn_train_bwd_kernel<bf16>"], stores=844, loads=1400)})
    assert [k for k, _ in build_gate(lines)] == ["gnn_forward_kernel<bf16>",
                                                 "gnn_train_bwd_kernel<bf16>"]


def test_build_gate_reads_the_functions_ptxas_compiled_apart():
    """A device function of a kernel's source that ptxas compiled as a
    function of its own (the compiler did not inline it) belongs to the
    instance of its compute dtype: its serialisation notes and its spills
    fail that instance; another kernel of the source keeps its registers
    apart."""
    body = "_ZN3gnn12forward_bodyIfEEvRKNS_4DimsEPKT_RKNS_7WeightsIS4_EEiPKiPKsSE_RKNS_7FwdBufsIS4_EEPh"
    fwd = MANGLED["gnn_forward_kernel<float>"]
    lines = (["== gnn_forward.cu"]
             + [f"ptxas info    : (C7510) Potential Performance Loss: wgmma.mma_async "
                f"instructions are serialized due to wgmma pipeline crossing function boundary "
                f"at a function call in the function '{body}'"]
             + properties(fwd) + properties(body, stores=2036, loads=1252)
             + ["== gnn_train_bwd.cu"] + properties(MANGLED["gnn_train_bwd_kernel<float>"])
             + properties("_ZN49_GLOBAL__N__32d220ed_16_gnn_train_bwd_cu_49e3584418sum_samples"
                          "_kernelEPKfiiPf", registers=32))
    got = build_gate(lines)
    assert [k for k, _ in got] == ["gnn_forward_kernel<float>", "gnn_forward_kernel<float>"]
    assert got[0][1].startswith("wgmma serialized: (C7510)")
    assert got[1][1] == "spills: 2036 bytes stored, 1252 bytes loaded"
    from chip_smoke import ptxas_kernels

    assert ptxas_kernels(lines)["gnn_train_bwd_kernel<float>"]["registers"] == 255


def test_build_gate_fails_on_a_bf16_k1_spill():
    fn = MANGLED["rollout_chunk_kernel<bf16>"]
    got = build_gate(report(**{"rollout_chunk_kernel<bf16>": properties(fn, stores=44, loads=44,
                                                                        registers=128)}))
    assert got == [("rollout_chunk_kernel<bf16>", "spills: 44 bytes stored, 44 bytes loaded")]


def test_build_gate_fails_on_an_f32_k1_spill():
    """float32 K1 (the CUDA-core parity body) is gated as every instance is:
    its spills, and those of a device function of its source that ptxas
    compiled apart, fail the build and are reported."""
    fn = MANGLED["rollout_chunk_kernel<float>"]
    lines = report(**{"rollout_chunk_kernel<float>": properties(fn, stores=32, loads=32)})
    assert build_gate(lines) == [("rollout_chunk_kernel<float>",
                                  "spills: 32 bytes stored, 32 bytes loaded")]
    from chip_smoke import ptxas_kernels

    assert ptxas_kernels(lines)["rollout_chunk_kernel<float>"]["spill_stores"] == 32
    helper = "_ZN49_GLOBAL__N__5c1e0f2a_16_rollout_chunk_cu_7d2e1b3c11rollout_f32ERK6ParamsPh"
    lines = (["== rollout_chunk.cu"] + properties(fn)
             + properties(helper, stores=16, loads=8, registers=64))
    assert build_gate(lines) == [("rollout_chunk_kernel<float>",
                                  "spills: 16 bytes stored, 8 bytes loaded")]


@pytest.mark.parametrize("dtype", ["bf16", "float"])
@pytest.mark.parametrize("code", ["C7510", "C7520"])
def test_build_gate_fails_on_a_k1_c75xx_note(code, dtype):
    """A C75xx note on either K1 instance fails the build, in its kernel or in a
    device function of ``rollout_chunk.cu`` that ptxas compiled apart."""
    instance = f"rollout_chunk_kernel<{dtype}>"
    fn = MANGLED[instance]
    note = [f"ptxas info    : ({code}) Potential Performance Loss: wgmma.mma_async instructions "
            f"are serialized due to the presence of Extern calls in the function '{fn}'"]
    got = build_gate(report(**{instance: note + properties(fn)}))
    assert got == [(instance, got[0][1])] and got[0][1].startswith(f"wgmma serialized: ({code})")
    helper = ("_ZN49_GLOBAL__N__5c1e0f2a_16_rollout_chunk_cu_7d2e1b3c12relation_mlpERK9EdgeGraph"
              + ("P13__nv_bfloat16" if dtype == "bf16" else "Pf"))
    lines = (["== rollout_chunk.cu"] + [note[0].replace(fn, helper)] + properties(fn)
             + properties(helper, registers=64))
    assert [k for k, _ in build_gate(lines)] == [instance]


def test_build_gate_counts_a_w160_helper_to_the_w160_instance():
    """A device function of K1's width-160 body (namespace w160) that ptxas
    compiled apart belongs to that body's instance, not to the 128 body's."""
    fn = MANGLED["rollout_chunk_kernel_w160<bf16>"]
    helper = ("_ZN49_GLOBAL__N__5c1e0f2a_16_rollout_chunk_cu_7d2e1b3c4w16012relation_mlpERK6Para"
              "msRKNS0_5BlockEPhR8SubClock")
    lines = (["== rollout_chunk.cu"] + properties(MANGLED["rollout_chunk_kernel<bf16>"])
             + properties(fn) + properties(helper, stores=12, loads=12, registers=168))
    assert build_gate(lines) == [("rollout_chunk_kernel_w160<bf16>",
                                  "spills: 12 bytes stored, 12 bytes loaded")]
