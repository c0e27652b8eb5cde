"""``python -m ldiffusion_tpu_torch.segmentor`` → the segmentor CLI."""
from ldiffusion_tpu_torch.segmentor.cli import main

if __name__ == "__main__":
    main()
