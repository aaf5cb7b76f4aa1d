"""``examples/ragged_serving_torch.py`` and
``examples/sessions_serving_torch.py`` against their references, run as
users run them.

Both ports run with ``--device cpu`` (in this process, while the reference
script runs as a process of its own): the same
traffic, ladders, pool and checkpoint -> restore -> resume.  Every number
the two print must agree line by line: lengths, shapes, ladders, counts,
flush rungs, evictions and reference indices exactly, other values within
rtol 2e-4, atol 2e-5 (plus one unit in the last printed digit).  The
wall-clock figures (the batcher's cold milliseconds, the pool's p99
staleness) are left out.  The printed identities must hold: padding is the
identity to the bit against the unpadded call of one path (on the CPU;
the card holds it to the kernels' tolerance, see the example), and the
restored pool is bit-identical before and after the resumed round.
"""
import pytest

import _torch_examples as ex

NAMES = ("ragged_serving_torch", "sessions_serving_torch")
WALL_CLOCK = (r"in \d+ ms", r"staleness [\d.]+ ms")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    return {name: ex.run_beside_reference(name, tmp) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(runs, name):
    ex.check_runs(runs[name][0], name)


@pytest.mark.parametrize("name", NAMES)
def test_example_prints_the_references_numbers(runs, name):
    port, ref = (ex.lines(r) for r in runs[name])
    ex.compare_lines(ref, port, drop=WALL_CLOCK)


def test_ragged_padding_is_the_identity(runs):
    port = "\n".join(ex.lines(runs["ragged_serving_torch"][0]))
    assert "max |err| vs unpadded call: 0.0e+00" in port
    assert "max |err| vs the ragged batch: 0.0e+00" in port


def test_sessions_restore_is_bit_identical(runs):
    port = "\n".join(ex.lines(runs["sessions_serving_torch"][0]))
    assert "sessions bit-identical: True" in port
    assert "still identical: True" in port
