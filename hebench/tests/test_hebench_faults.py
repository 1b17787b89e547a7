"""`correct` comes out false when the timed path is broken underneath, and
the control (the reference in a lower precision, in the program's place)
reads above the cell's limit: each at a size the CPU can hold."""

import dataclasses
import json

import pytest

from _tiny import make_root
from hebench import harness


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def unchanged(request):
    """A step that returns its state unchanged: the request's own input."""
    def run(i):
        out = request(i)
        src = request.__self__.pool[i % len(request.__self__.pool)]
        return src[0] if isinstance(src, tuple) else src
    return run


def altered(request):
    """An answer altered where it is produced: one coefficient of one
    limb of the output ciphertext, plus one."""
    def run(i):
        out = request(i)
        data = out.ct.data.clone()
        data[1, 0, 7] += 1
        return dataclasses.replace(out, ct=dataclasses.replace(out.ct,
                                                               data=data))
    return run


@pytest.mark.parametrize("cell", ["tiny.mulrelin", "tiny.ptmul",
                                  "mini.infer", "mini.infer_fused"])
@pytest.mark.parametrize("fault", [unchanged, altered])
def test_broken_path_is_not_correct(root, cell, fault):
    r = harness.run_cell(cell, 7, 0.1, False, "cpu", root, broken=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,control", [("tiny.mulrelin", "complex64"),
                                          ("tiny.ptmul", "complex64"),
                                          ("mini.infer_fused", "float16")])
def test_control_fails_the_limit(root, cell, control):
    r = harness.run_cell(cell, 2 ** 31 + 3, 0.1, False, "cpu", root,
                         controls=[control])
    assert r["correct"], r["checks"]
    got = r["controls"][control]
    assert got["correct"] is False, got
    assert any(c["value"] > c["limit"] for c in got["checks"].values())


def test_calibrate_reads_program_and_control(root, capsys):
    from hebench import calibrate
    assert calibrate.main(["--workload", "tiny.ptmul", "--seconds", "0.1",
                           "--seeds", "5", "6", "--control", "complex64",
                           "--device", "cpu"], root=root) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines[:2]] == [5, 6]
    assert all(x["controls"]["complex64"]["correct"] is False
               for x in lines[:2])
    last = lines[-1]
    assert last["limits"] == {"max_err_log2": -24.5, "not_small": 0}
    assert last["program_correct"] is True
    assert last["control_correct"] == {"complex64": False}
    assert last["program_max"]["max_err_log2"] < \
        last["control_min"]["complex64.max_err_log2"]


def test_calibrate_fails_where_a_control_passes(tmp_path, capsys):
    """Under a limit too loose to separate the control from the program,
    calibrate says so and exits with 1."""
    from hebench import calibrate
    root = make_root(tmp_path)
    cell = root / "hebench" / "workloads" / "tiny.ptmul.json"
    doc = json.loads(cell.read_text())
    doc["limits"]["max_err_log2"] = -10.0
    cell.write_text(json.dumps(doc))
    assert calibrate.main(["--workload", "tiny.ptmul", "--seconds", "0.1",
                           "--seeds", "5", "--control", "complex64",
                           "--device", "cpu"], root=root) == 1
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["program_correct"] is True
    assert last["control_correct"] == {"complex64": True}
