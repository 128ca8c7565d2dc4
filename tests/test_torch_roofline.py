"""The port's roofline (``repro_torch.tune.roofline``) against the JAX
package's, on the CPU.

The arithmetic and the table are the reference's: ``model_flops_per_
device`` for every cell of the grid, and the same dry-run records
through both packages' ``load_results``, ``analyse_record`` and
``render_table``, with the reference's constants set to the H100's
for the comparison.  The constants come from the card's name: the H100's
entry is the spec sheet's, a card the table lacks raises naming it, and
without a card a caller must name the entry.
"""

import json

import pytest

from repro.launch import cells as ref_cells
from repro.tune import roofline as ref_roofline
from repro_torch.launch import cells
from repro_torch.tune import roofline

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("chips", [256, 512])
def test_model_flops_match_the_reference(chips):
    for arch, shape in cells.all_cells():
        assert roofline.model_flops_per_device(arch, shape, chips) == \
            ref_roofline.model_flops_per_device(arch, shape, chips), (
                arch, shape)


def _records():
    """A record a cell: skipped ones as the CLI writes them, one error,
    one calibrated, the rest with numbers made from the cell's index."""
    out = []
    for i, (arch, shape) in enumerate(cells.all_cells()):
        skip = ref_cells.cell_is_skipped(arch, shape)
        if skip:
            out.append({"arch": arch, "shape": shape, "mesh_desc": "single",
                        "skipped": skip, "ok": True})
            continue
        rec = {"arch": arch, "shape": shape, "mesh_desc": "single",
               "flops_per_device": 1.5e13 * (i + 1),
               "bytes_per_device": 3.0e11 * (40 - i),
               "argument_bytes": 2.0e9 * i, "output_bytes": 1.0e9,
               "temp_bytes": 7.5e9 * (i % 7), "collective_bytes": {
                   "all-gather": 1.0e9 * i, "all-reduce": 4.0e8 * (i % 3)},
               "num_while_loops": 0, "scan_length": 24,
               "compile_seconds": 1.0, "skipped": None, "ok": True}
        if i == 5:
            rec = {"arch": arch, "shape": shape, "mesh_desc": "single",
                   "ok": False, "error": "RuntimeError: out of patience"}
        if i == 9:
            rec["calibrated"] = {"flops_per_device": 2.0e15,
                                 "bytes_per_device": 1.0e12,
                                 "collective_bytes": {"all-reduce": 3.0e9}}
        out.append(rec)
    return out


def test_records_analyse_and_render_as_the_reference(tmp_path, monkeypatch):
    dev = roofline.constants(H100)
    monkeypatch.setattr(ref_roofline, "PEAK_FLOPS", dev["peak_flops"])
    monkeypatch.setattr(ref_roofline, "HBM_BW", dev["hbm_bw"])
    monkeypatch.setattr(ref_roofline, "ICI_BW", dev["ici_bw"])
    path = tmp_path / "cells.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    mine, theirs = (roofline.load_results(str(path)),
                    ref_roofline.load_results(str(path)))
    assert mine == theirs and len(mine) == 40
    assert roofline.load_results(str(tmp_path / "absent.jsonl")) == {}
    rows = [roofline.analyse_record(r, 256, dev) for r in mine.values()]
    ref_rows = [ref_roofline.analyse_record(r, 256) for r in theirs.values()]
    assert rows == ref_rows
    assert sum("skipped" in r for r in rows) == 8
    assert sum("error" in r for r in rows) == 1
    assert sum(r.get("calibrated", False) for r in rows) == 1
    table = roofline.render_table(rows)
    assert table == ref_roofline.render_table(ref_rows)
    assert len(table.splitlines()) == 42


def test_constants_are_the_cards_spec_sheet():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == (
        989e12, 3.35e12, 50e9)
    dev = roofline.constants(H100)
    assert dev == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 50e9,
                   "nvlink_bw": 450e9}
    with pytest.raises(KeyError, match="NVIDIA A100-SXM4-80GB"):
        roofline.constants("NVIDIA A100-SXM4-80GB")


def test_without_a_card_the_caller_names_the_entry():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: its name is read from it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.constants()
    rec = {"arch": "qwen1.5-0.5b", "shape": "train_4k", "ok": True,
           "flops_per_device": 1.0, "bytes_per_device": 1.0,
           "collective_bytes": {}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.analyse_record(rec, 256)


def test_cli_renders_a_dry_run(tmp_path, capsys):
    path = tmp_path / "cells.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    assert roofline.main([str(path), "--device", H100]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("| arch | shape | compute(s)")
    with pytest.raises(KeyError, match="TPU v5e"):
        roofline.main([str(path), "--device", "TPU v5e"])
