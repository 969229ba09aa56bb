"""``chip_smoke.py``'s phases on the CPU at a tiny size.

On the card the script runs them at full width with the compiled kernels;
here the kernels run in the interpreter, which checks each phase's control
flow and its comparisons against the jnp references before a card is used.
"""

import pytest

import chip_smoke

TINY = chip_smoke.Sizes(flag_n=4000, flag_w=128, flag_h=64, gate_n=400,
                        gate_wh=64, train_n=2000, train_w=96, train_h=64,
                        shard_n=2000, iters=1)


@pytest.mark.parametrize("phase", ["phase_parity", "phase_forward",
                                   "phase_train"])
def test_single_card_phase(phase):
    getattr(chip_smoke, phase)(TINY, "cpu")


def test_multi_card_phase():
    chip_smoke.multi_card(TINY, "cpu", ndev=4)


def test_refuses_without_a_gpu(monkeypatch, capsys):
    """Off the GPU the script exits non-zero and prints no result."""
    monkeypatch.setattr("sys.argv", ["chip_smoke.py"])
    with pytest.raises(SystemExit) as e:
        chip_smoke.main()
    assert e.value.code == 1
    assert '"ok"' not in capsys.readouterr().out
