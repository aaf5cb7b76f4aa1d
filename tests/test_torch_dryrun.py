"""``repro_torch.launch.dryrun`` and ``obs.record_cost``.

- ``rules_for`` equals the reference's dict for every cell (and with
  overrides).
- The fake world lives in a subprocess (one for the module): the CLI over
  every arch at ``long_500k`` on both production meshes (the eight
  full-attention archs skipped with the reference's reason, zamba2's and
  rwkv6's decode cells run), two decode cells of the production mesh in
  the reference's layout (each rank its rows of the requests and its
  block of each cache's sequence), and
  a dense LM-loss train step of reduced qwen3-4b on a 2 x 2 mesh whose
  FLOPs a rank times 4 lie within 10% of the same step's FLOPs on one
  rank alone.
- A ``prefill_32k`` cell executes the reference's ``seq: "model"`` rule
  (each rank its block of 2,048 of the prompt, the keys and values
  gathered a layer), and so does a train cell whose rules carry it; a
  train cell whose batch 256 divides has none.
- phi3.5-moe-42b-a6.6b's ``decode_32k`` cell runs on both production
  meshes, its one dispatch group a step spread over the data ranks.
- deepseek-v2-lite-16b's ``prefill_32k`` cell runs under
  ``rule_overrides={"seq": "model"}``: MLA's heads, the dense MLP's
  ``ff`` and the experts over the model axis that cuts the prompt.
- ``record_cost`` counts 2·m·n·k FLOPs for a matmul and publishes its
  gauges under the reference's names.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import specs as tspecs

HERE = Path(__file__).resolve().parent


def _reference_dryrun():
    """``repro.launch.dryrun`` without its XLA_FLAGS reaching this
    process's later subprocesses (it sets 512 host devices on import)."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdryrun


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_rules_for_equals_the_reference(arch):
    jdryrun = _reference_dryrun()
    for shape in list(tspecs.SHAPES) + ["unknown"]:
        assert tdryrun.rules_for(arch, shape) == jdryrun.rules_for(arch,
                                                                   shape)
        over = {"kv_seq": "data", "fsdp": None}
        assert tdryrun.rules_for(arch, shape, over) == \
            jdryrun.rules_for(arch, shape, over)


def test_h100_constants():
    assert tdryrun.PEAK_FLOPS == 989.4e12 and tdryrun.HBM_BW == 3.35e12
    bw = tdryrun.axis_bandwidth(tdryrun.production_mesh())
    assert bw == {"data": 50e9, "model": 50e9}   # 16 ranks span two nodes
    small = tdryrun.axis_bandwidth(tdryrun.AbstractMesh((2, 2),
                                                        ("data", "model")))
    assert small == {"data": 450e9, "model": 450e9}


def test_lower_cell_skips_without_a_world():
    res = tdryrun.lower_cell("qwen3-4b", "long_500k")
    assert res == {"arch": "qwen3-4b", "shape": "long_500k",
                   "skipped": tspecs.cell_is_runnable("qwen3-4b",
                                                      "long_500k")[1]}


_CHILD = """
import dataclasses, json, sys, torch
from repro_torch import configs, train
from repro_torch import models as M
from repro_torch.distributed.ctx import AbstractMesh
from repro_torch.launch import dryrun, specs
from repro_torch.obs.compile import CostCounter
from repro_torch.optim import sgd
out = {}
for arch in ("qwen2-vl-2b", "whisper-large-v3"):
    out[arch] = dryrun.lower_cell(arch, "decode_32k")
out["prefill"] = dryrun.lower_cell("qwen2-vl-2b", "prefill_32k")
out["phi_decode"] = {pod: dryrun.lower_cell("phi3.5-moe-42b-a6.6b",
                                            "decode_32k",
                                            multi_pod=pod == "pod2")
                     for pod in ("pod1", "pod2")}
out["deepseek"] = {k: dryrun.lower_cell("deepseek-v2-lite-16b",
                                        "prefill_32k", rule_overrides=over)
                   for k, over in (("whole", None), ("cut", {"seq": "model"}))}
specs.SHAPES["train_flops"] = dict(kind="train", seq=16, batch=256)
cfg = configs.reduce_config(configs.get_config("qwen3-4b"))
res = dryrun.lower_cell("qwen3-4b", "train_flops", cfg=cfg,
                        mesh=AbstractMesh((2, 2), ("data", "model")),
                        opt=sgd(), forward_collectives=True)
rwkv = configs.reduce_config(configs.get_config("rwkv6-1.6b"))
specs.SHAPES["rwkv_long"] = dict(kind="train", seq=256, batch=8)
cells = []
for seqs in ((1000, 2000, 4000), (16, 32, 64)):   # run whole, extrapolated
    dryrun.POLY_SEQ = seqs
    cells.append(dryrun.lower_cell(
        "rwkv6-1.6b", "rwkv_long", cfg=rwkv,
        mesh=AbstractMesh((2, 2), ("data", "model"))))
out["rwkv"] = cells
dryrun.close_world()
model = M.init_params(0, cfg, torch.bfloat16, device="meta")
opt = sgd()
state = opt.init(model)
step = train.make_train_step(cfg, opt)
with CostCounter() as cc:
    step(model, state, specs.batch_specs_for(cfg, "train_flops"))
out["flops"] = dict(mesh=res, one=cc.flops)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    """The CLI's run over the ``long_500k`` cells and the in-process
    cells of ``_CHILD``, each in a process of its own, side by side."""
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    out = tmp_path_factory.mktemp("dryrun")
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for cmd in ([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", "all", "--shape", "long_500k",
                          "--both-meshes", "--out", str(out)],
                         [sys.executable, "-c", _CHILD])]
    (cli_out, cli_err), (cells, err) = [p.communicate(timeout=600)
                                        for p in procs]
    assert procs[1].returncode == 0, err
    cli = subprocess.CompletedProcess(procs[0].args, procs[0].returncode,
                                      cli_out, cli_err)
    return cli, out, json.loads(cells.strip().splitlines()[-1])


def test_cli_runs_every_long_context_cell(child):
    cli, out, _ = child
    assert cli.returncode == 0, cli.stdout + cli.stderr
    assert "[FAIL]" not in cli.stdout
    for arch in tconfigs.ARCH_IDS:
        for pod in ("pod1", "pod2"):
            res = json.loads((out / f"{arch}__long_500k__{pod}.json")
                             .read_text())
            ok, why = tspecs.cell_is_runnable(arch, "long_500k")
            if not ok:
                assert res["skipped"] == why
                continue
            assert res["devices"] == (512 if pod == "pod2" else 256)
            assert res["hlo_flops_per_dev"] > 0
            assert res["memory_analysis"]["argument_size_bytes"] > 0
            assert res["rules"] == {k: str(v) for k, v in
                                    tdryrun.rules_for(arch,
                                                      "long_500k").items()}


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-large-v3"])
def test_production_decode_cells(child, arch):
    """The decode cells run the reference's layout: a rank holds its rows
    of the requests (128 over the data axis) and its block of each
    attention cache's sequence (over the model axis), so its argument
    bytes less its parameters are its blocks of the cache and the whole
    batch's tokens; each layer combines its blocks with an all-gather."""
    from repro_torch.distributed.model_parallel import local_cache
    res = child[2][arch]
    assert res["mesh"] == "16x16" and res["kind"] == "decode"
    assert res["hlo_flops_per_dev"] > 0 and res["hlo_bytes_per_dev"] > 0
    mem = res["memory_analysis"]
    assert mem["argument_size_bytes"] > mem["param_bytes"] > 0
    assert res["dominant"] in ("compute_s", "memory_s", "collective_s")
    # weight-stationary decode: no FSDP gather of the parameters
    assert res["rules"]["fsdp"] == "None"
    assert res["rules"]["kv_seq"] == "model"
    cfg = tconfigs.get_config(arch)
    tokens, cache, _ = tspecs.decode_inputs_for(cfg, "decode_32k")
    rank = tdryrun.tree_bytes(local_cache(
        cache, tdryrun.production_mesh(),
        tdryrun.rules_for(arch, "decode_32k"), device="meta"))
    extra = tdryrun.tree_bytes(tokens)
    assert mem["argument_size_bytes"] - mem["param_bytes"] == rank + extra
    assert mem["output_size_bytes"] == rank + extra
    if arch == "qwen2-vl-2b":     # 1/256 of the whole 122,138,132,480
        assert abs(rank + extra - (477_102_080 + extra)) <= \
            0.01 * (477_102_080 + extra)
    assert res["collectives"]["all-gather"]["count"] >= cfg.n_layers


@pytest.mark.parametrize("pod", ["pod1", "pod2"])
def test_moe_decode_cell_whose_dispatch_group_straddles_data_ranks(child,
                                                                   pod):
    """phi3.5-moe-42b-a6.6b's ``decode_32k`` cell runs on both
    production meshes (it raised while a dispatch group could not
    straddle ranks): a step's 128 tokens are one capacity-bound group
    spread over the 16 (32) data ranks, so each MoE layer all-gathers
    every data rank's 16 per-expert counts once (``moe_pos``), under the
    reference's rules for the cell."""
    arch = "phi3.5-moe-42b-a6.6b"
    res = child[2]["phi_decode"][pod]
    assert "error" not in res and "skipped" not in res, res
    assert res["mesh"] == ("16x16" if pod == "pod1" else "2x16x16")
    assert res["rules"] == {k: str(v) for k, v in
                            tdryrun.rules_for(arch, "decode_32k").items()}
    cfg = tconfigs.get_config(arch)
    P = 16 if pod == "pod1" else 32
    got = res["collectives_by_tag"]["moe_pos"]["all-gather"]
    assert got["count"] == cfg.n_layers
    assert got["result_bytes"] == cfg.n_layers * P * cfg.n_experts * 4
    assert res["hlo_flops_per_dev"] > 0


def test_prefill_cells_keep_the_sequence_rule_and_train_cells_drop_it(
        child):
    """A cell runs under its own rules, ``seq`` included: a prefill cell's
    rules cut the prompt over ``"model"``, and, since training runs a
    block of every sequence, a train cell's too
    (qwen3-4b's ``train_tiny`` cell of batch 8 carries ``seq: "model"``;
    no ``train_4k`` cell's rules have it, its batch of 256 split over both
    axes instead); qwen2-vl-2b's ``prefill_32k`` cell on 16 × 16 runs each
    rank's 2 requests over its block of 2,048 positions: one ``sp_kv``
    all-gather a layer of the whole prompt's keys and values, one
    ``sp_last``, and useful FLOPs over executed about 16 times the
    0.0231 of every model rank running the whole prompt."""
    for arch in tconfigs.ARCH_IDS:
        assert tdryrun.rules_for(arch, "train_4k").get("seq") is None
    tspecs.SHAPES["train_tiny"] = dict(kind="train", seq=8, batch=8)
    try:
        rules = tdryrun.rules_for("qwen3-4b", "train_tiny")
    finally:
        del tspecs.SHAPES["train_tiny"]
    assert rules["seq"] == "model"
    res = child[2]["prefill"]
    assert res["rules"]["seq"] == res["executed_rules"]["seq"] == "model"
    assert child[2]["flops"]["mesh"]["executed_rules"].get("seq") is None
    cfg = tconfigs.get_config("qwen2-vl-2b")
    tags = res["collectives_by_tag"]
    assert tags["sp_kv"]["all-gather"]["count"] == cfg.n_layers
    assert tags["sp_last"]["all-gather"]["count"] == 1
    # 2 requests × 32,768 positions × 2 (k, v) × Hkv × hd × bf16, a layer
    kv = 2 * 32768 * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    assert tags["sp_kv"]["all-gather"]["result_bytes"] == cfg.n_layers * kv
    assert 0.3 < res["useful_flops_ratio"] < 0.45
    assert "block of the prompt" in res["memory_analysis"]["temp_size_note"]


def test_moe_and_mla_prefill_cell_under_the_sequence_override(child):
    """deepseek-v2-lite-16b's ``prefill_32k`` cell on 16 × 16 with
    ``rule_overrides={"seq": "model"}`` runs (it raised while MLA, the MoE
    and tensor parallelism over the cut axis were unported): each rank
    holds its 2 requests' block of 2,048 positions, every MLA layer and
    the dense MLP gather the group's rows (``sp_tp_in``, 2 × 32,768 × 2,048
    bf16 a layer) and reduce-scatter their sums back (``sp_tp_out``), and
    each of the 26 MoE layers gathers its tokens and reduce-scatters its
    experts' and shared experts' sums once (``sp_moe_in`` /
    ``sp_moe_out``).  Its peak a rank is below the cell with the sequence
    whole, by less than 5%: attention's (2, 1, 32,768, 32,768) float32
    scores of a rank's one head dominate either way."""
    cells = child[2]["deepseek"]
    whole, cut = cells["whole"], cells["cut"]
    assert whole["executed_rules"].get("seq") is None
    assert cut["executed_rules"]["seq"] == "model"
    cfg = tconfigs.get_config("deepseek-v2-lite-16b")
    L, n_moe = cfg.n_layers, cfg.n_layers - cfg.moe_layer_start
    tags = cut["collectives_by_tag"]
    for tag, kind, n in (("sp_tp_in", "all-gather", L + 1),
                         ("sp_tp_out", "reduce-scatter", L + 1),
                         ("sp_moe_in", "all-gather", n_moe),
                         ("sp_moe_out", "reduce-scatter", n_moe)):
        assert tags[tag][kind]["count"] == n, (tag, tags[tag])
    assert tags["sp_tp_in"]["all-gather"]["result_bytes"] == \
        (L + 1) * 2 * 32768 * cfg.d_model * 2
    assert "sp_kv" not in tags and "sp_latent" not in tags
    t_whole = whole["memory_analysis"]["temp_size_bytes"]
    t_cut = cut["memory_analysis"]["temp_size_bytes"]
    assert 0.95 * t_whole < t_cut < t_whole


def test_a_dense_steps_flops_split_over_the_2x2_mesh(child):
    got = child[2]["flops"]
    res, one = got["mesh"], got["one"]
    assert abs(res["hlo_flops_per_dev"] * 4 - one) <= 0.1 * one, (
        res["hlo_flops_per_dev"], one)
    assert res["collectives"] and res["forward_collectives"]
    assert res["collective_wire_bytes_per_dev"] > 0
    assert res["t_collective_s"] > 0 and res["t_compute_s"] > 0


def test_rwkv_cells_extrapolate_exactly(child):
    """An rwkv train cell read off the parabola through three short runs
    (``POLY_SEQ``'s lengths times the cell's two sequence blocks: its rules
    carry ``seq: "model"``) equals the cell run whole: FLOPs, unfused
    bytes (a quadratic), collectives and wire bytes, argument and output
    bytes; the peak live bytes, an estimate, within 5%."""
    whole, ex = child[2]["rwkv"]
    assert "extrapolated_from_seq" not in whole
    assert ex["executed_rules"]["seq"] == "model"
    assert ex["extrapolated_from_seq"] == [32, 64, 128]
    for k in ("hlo_flops_per_dev", "hlo_bytes_per_dev",
              "collective_wire_bytes_per_dev"):
        assert ex[k] == pytest.approx(whole[k], rel=1e-9), k
    for kind, c in whole["collectives"].items():
        assert ex["collectives"][kind]["count"] == c["count"], kind
        for k in ("result_bytes", "wire_bytes"):
            assert ex["collectives"][kind][k] == pytest.approx(
                c[k], rel=1e-9), (kind, k)
    for k in ("argument_size_bytes", "output_size_bytes", "param_bytes",
              "opt_state_bytes"):
        assert ex["memory_analysis"][k] == whole["memory_analysis"][k], k
    assert ex["memory_analysis"]["temp_size_bytes"] == pytest.approx(
        whole["memory_analysis"]["temp_size_bytes"], rel=0.05)


def test_record_cost_counts_a_matmul_and_publishes_its_gauges():
    from repro_torch import obs
    m, k, n = 3, 5, 7
    a, b = torch.randn(m, k), torch.randn(k, n)
    with obs.enabled_scope():
        got = obs.record_cost("mm", torch.matmul, a, b)
        snap = obs.snapshot()
    assert got["flops"] == 2 * m * n * k
    assert got["bytes"] == 4 * (m * k + k * n + m * n)
    assert got["raw"]["flops_by_op"] == {"aten.mm": 2.0 * m * n * k}
    names = json.dumps(snap)
    assert "pathsig_lowered_flops" in names and \
        "pathsig_lowered_bytes" in names
    assert a.device.type == "cpu"          # the arguments stay as they were


def test_record_cost_runs_a_module_on_meta_copies():
    from repro_torch import models as M
    from repro_torch.obs.compile import record_cost
    cfg = tconfigs.reduce_config(tconfigs.get_config("qwen3-4b"))
    model = M.init_params(0, cfg, device="cpu")
    tokens = torch.ones((2, 8), dtype=torch.int32)
    got = record_cost("forward", lambda m, t: m(t, remat="none"), model,
                      tokens)
    assert got["flops"] > 0 and got["bytes"] > 0
    assert all(p.device.type == "cpu" for p in model.parameters())
