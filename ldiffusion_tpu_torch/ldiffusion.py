"""``python -m ldiffusion_tpu_torch.ldiffusion``: the training command (the
reference's ``python -m LDiffusion.ldiffusion``, ``ldiffusion.py:326-331``)."""
from ldiffusion_tpu_torch.api import LDiffusionModel, main, parse_args  # noqa: F401

if __name__ == "__main__":
    main()
