"""Batch driver, variant 2: Zero123 training without the frozen
structure. Counterpart of the repository's `train_zero123_2.py`; see
`sgs_tpu_torch/train_zero123.py`.

    python -m sgs_tpu_torch.train_zero123_2
"""

from sgs_tpu_torch.train_zero123 import main

if __name__ == "__main__":
    main(freeze_xyz=False)
