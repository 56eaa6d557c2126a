"""The comparison that decides ``correct`` fails what it must: the control
(the reference at a budget that breaks a stated guarantee, in the program's
place) and a run driven through a broken program, once for each fault a
cell of one chip can have. Run on the CPU at a size a test can hold, through
the port's plain versions; the look for a chip is skipped."""
import dataclasses

import pytest
import torch

from benchmark import control, record, spec
from benchmark.loops import serve
from benchmark.run import program_counters, program_encode, run_cell


@pytest.fixture(autouse=True)
def short_serve(monkeypatch):
    """A serve run keeps 4 requests for the PSNR and waits 30 s past the
    window's close."""
    monkeypatch.setattr(serve, "PSNR_REQUESTS", 4)
    monkeypatch.setattr(serve, "DRAIN_S", 30.0)


def tiny(name, encoder_config=None):
    cell = spec.load_cell(name)
    if encoder_config:            # the fast encoder keeps a bake test short
        cell.config = spec.load_cell(encoder_config).config
    if cell.mix["loop"] == "bake":
        alphas = sorted({e["alpha"] for e in cell.mix["textures"]})
        cell.mix["textures"] = [
            {"size": 16, "count": 1, "alpha": alphas[0]},
            {"size": 8, "count": 1, "alpha": alphas[-1]}]
    else:
        cell.mix.update(sizes=[8, 16], frame=[2, 1], rate_per_s=12.0)
    return cell


def broken(fault):
    good = program_encode(True, "cpu")
    calls = [0]

    def encode(u8):
        out = good(u8)
        w = out.blocks.reshape(-1, 4).clone()
        if fault == "state_unchanged":        # the output as allocated
            w.zero_()
        elif fault == "half_left_out":
            w[(w.shape[0] + 1) // 2:] = 0
        elif fault == "answer_altered" and calls[0] == 10:   # in the window
            w[:, 1] ^= 0x0F0F0F0F
        calls[0] += 1
        return dataclasses.replace(out, blocks=w.reshape(out.blocks.shape))
    return encode


def run(cell, encode, seconds=1.0):
    torch.manual_seed(0)
    res, _ = run_cell(cell, 2**31 + 17, seconds, False, "cpu", encode,
                      program_counters())
    return res


CELLS = [("bc7enc16_default.serve_alpha", None),
         ("bc7_amd_q1.bake_opaque", "bc7enc16_default.serve_opaque")]


@pytest.mark.parametrize("name,cfg", CELLS)
def test_a_sound_run_is_correct(name, cfg):
    res = run(tiny(name, cfg), program_encode(True, "cpu"))
    assert res["correct"], res["checks"]
    assert res["checks"]["sse_excess"]["value"] == 0.0
    assert res["info"]["sampled_blocks"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("name,cfg", CELLS)
def test_a_broken_program_is_not_correct(name, cfg, fault):
    res = run(tiny(name, cfg), broken(fault))
    assert not res["correct"], res["checks"]


def test_a_call_that_raises_is_missing():
    def encode(u8):
        raise RuntimeError("no words")
    res = run(tiny(*CELLS[0]), encode)
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["missing"]["value"] > 0


@pytest.mark.parametrize("name,textures", [
    ("bc7enc16_default.serve_opaque", 0),
    ("bc7enc16_default.serve_alpha", 0),
    ("bc7_amd_q1.bake_opaque", 2),
    ("bc7_amd_q1.bake_alpha", 2)])
def test_the_control_is_not_correct(monkeypatch, name, textures):
    cell = tiny(name)
    if cell.mix["loop"] == "serve":
        cell.mix.update(sizes=[32, 64], frame=[2, 1], rate_per_s=40.0)
        monkeypatch.setattr(record, "CHECK_BLOCKS_PER_CALL", 24)
    else:
        cell.mix["textures"][0]["size"] = 64
        monkeypatch.setattr(record, "CHECK_BLOCKS_PER_CALL", 64)
    nums = control.readings(cell, 2**31 + 3, 1.0, textures,
                            torch.device("cpu"))
    limits = cell.limits
    assert any(nums[k] > limits[k] for k in ("sse_excess", "worst_block")), \
        nums
