"""The roofline's byte count on a hand-worked step."""

from portbench import roofline


def test_step_bytes_hand_worked():
    # 16-byte keys: a key row is 4 words and a length word (20 bytes), a
    # history row adds its version (24). 3 rows before, 5 after: 192.
    # Feed: 2 txns x (snapshot 4 + too-old flag 1) = 10; 2 reads and 2
    # writes x (begin 20 + end 20 + txn id 4) = 176; commit and oldest 8.
    # Verdict flags: 2.
    assert roofline.step_bytes(3, 5, 2, 2, 2, 4) == 192 + 10 + 176 + 8 + 2


def test_peaks_table():
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] \
        == 3.35e12
    assert roofline.peaks("no such card") is None
