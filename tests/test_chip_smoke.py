"""chip_smoke.py: its phases at tiny sizes on the CPU (GPU kernels in the
Pallas interpreter, the codec on the XLA route), its refusal to run
without a GPU, and the whole run on a GPU (``gpu`` marker)."""

import json

import pytest

import chip_smoke


def test_parity_phase_tiny():
    chip_smoke.parity_phase(sizes=((3, 200), (2, 8)), interpret=True)


def test_numpy_words_reference():
    """The host bit packer the parity phase trusts, on a hand example:
    codes 1 (len 1), 01 (len 2), 001 (len 3) -> stream 1 01 001 ..."""
    import numpy as np

    enc = np.zeros(256, np.int64)
    for sym, (code, ln) in enumerate([(0b1, 1), (0b01, 2), (0b001, 3)]):
        enc[sym] = (code << (15 - ln)) << 4 | ln
    rows = np.array([[0], [1], [2]], np.uint8)
    words = chip_smoke.numpy_words(rows, enc, 2)
    assert words.shape == (2, 1)
    assert int(words[0, 0]) == 0b101001 << 26 and int(words[1, 0]) == 0


def test_device_api_phase_tiny():
    chip_smoke.device_api_phase(n_block=3000, n_shared=2, batch=(3, 2048))


def test_bytes_api_phase_tiny():
    chip_smoke.bytes_api_phase(
        sizes=(1000, 5000, 20000), uniform_n=5000, block_bytes=8192, ref_n=40000
    )


def test_four_phase_virtual_devices():
    chip_smoke.four_phase(n_block=4096, k=64)


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu, capsys):
    chip_smoke.main([])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(last)
    assert result["ok"] and result["device"]["platform"] == "gpu"
