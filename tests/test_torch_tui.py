"""circuitscape_tpu_torch.tui, case for case with tests/test_tui.py:
drive the prompts with scripted input and check the produced config
and run (on the CPU), mirroring the INIBuilder flow."""

import os

import numpy as np
import torch

from circuitscape_tpu import tui as jtui
from circuitscape_tpu_torch import tui

torch.set_num_threads(1)

F32_TOL = 1e-5


def test_wizard_runs_job(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cell = tmp_path / "cell.asc"
    pts = tmp_path / "pts.asc"
    hdr = ("ncols         5\nnrows         5\nxllcorner     0\n"
           "yllcorner     0\ncellsize      1\nNODATA_value  -9999\n")
    cell.write_text(hdr + "\n".join(["1 1 1 1 1"] * 5) + "\n")
    pts.write_text(hdr + "1 0 0 0 2\n0 0 0 0 0\n0 0 0 0 0\n"
                   "0 0 0 0 0\n3 0 0 0 0\n")

    script = [
        "",            # data type -> raster
        "",            # scenario -> pairwise
        str(cell),     # habitat file
        "",            # is resistances -> yes
        str(pts),      # point file
        "",            # 8 neighbors
        "",            # average conductance
        "",            # polygons? no
        "",            # mask? no
        "",            # current maps? no
        "",            # voltage maps? no
        "",            # solver cg+amg
        str(tmp_path / "wiz.out"),  # output file
        "",            # run now
    ]
    answers = iter(script)
    outputs = []
    r = tui.start(input_fn=lambda *_: next(answers),
                  print_fn=lambda *a: outputs.append(" ".join(map(str, a))),
                  device="cpu")
    assert r.shape == (4, 4)
    assert np.all(np.isfinite(r))
    assert os.path.isfile(tmp_path / "wiz_resistances.out")
    # the JAX package's wizard on the same answers gives the same job
    script[-2] = str(tmp_path / "wiz_jax.out")
    answers = iter(script)
    ref = jtui.start(input_fn=lambda *_: next(answers),
                     print_fn=lambda *a: None)
    assert np.all(np.abs(r - ref) <= F32_TOL * np.abs(ref))


def test_filepicker_browse(tmp_path, monkeypatch):
    """The interactive picker (filepicker.jl parity): navigate into a
    subdirectory by number, pick a file by number."""
    monkeypatch.chdir(tmp_path)
    sub = tmp_path / "data"
    sub.mkdir()
    target = sub / "cell.asc"
    target.write_text("ncols 1\n")
    (tmp_path / "zzz.txt").write_text("x")

    # from tmp_path: entries are [../, data/, zzz.txt] -> pick 2 (data/),
    # then inside: [../, cell.asc] -> pick 2 (the file)
    answers = iter(["?", "2", "2"])
    p = tui._ask_path("file", input_fn=lambda *_: next(answers),
                      print_fn=lambda *a: None, browse=True)
    assert os.path.samefile(p, target)


def test_filepicker_typed_path(tmp_path):
    target = tmp_path / "habitat.asc"
    target.write_text("ncols 1\n")
    answers = iter(["?", str(tmp_path), "2"])
    p = tui._ask_path("file", input_fn=lambda *_: next(answers),
                      print_fn=lambda *a: None, browse=True)
    assert p == str(target)


def test_wizard_writes_ini(tmp_path):
    cell = tmp_path / "cell.asc"
    pts = tmp_path / "pts.asc"
    hdr = ("ncols         5\nnrows         5\nxllcorner     0\n"
           "yllcorner     0\ncellsize      1\nNODATA_value  -9999\n")
    cell.write_text(hdr + "\n".join(["1 1 1 1 1"] * 5) + "\n")
    pts.write_text(hdr + "1 0 0 0 2\n0 0 0 0 0\n0 0 0 0 0\n"
                   "0 0 0 0 0\n3 0 0 0 0\n")
    script = [
        "", "", str(cell), "", str(pts), "", "", "", "", "", "", "2",
        str(tmp_path / "wiz.out"),
        "2",           # write ini and exit
    ]
    answers = iter(script)
    cfg = tui.start(input_fn=lambda *_: next(answers),
                    print_fn=lambda *a: None, device="cpu")
    assert cfg["solver"] == "cholmod"
    assert os.path.isfile(tmp_path / "wiz.ini")
    text = (tmp_path / "wiz.ini").read_text()
    assert "solver = cholmod" in text
    # the JAX package's wizard writes the same INI
    script[-2] = str(tmp_path / "jax" / "wiz.out")
    answers = iter(script)
    jcfg = jtui.start(input_fn=lambda *_: next(answers),
                      print_fn=lambda *a: None)
    assert {k: v for k, v in jcfg.items() if k != "output_file"} == \
        {k: v for k, v in cfg.items() if k != "output_file"}
    jtext = (tmp_path / "jax" / "wiz.ini").read_text()
    assert jtext.replace(str(tmp_path / "jax"), str(tmp_path)) == text
