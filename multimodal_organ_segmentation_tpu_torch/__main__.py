"""``python -m multimodal_organ_segmentation_tpu_torch --mode ...``: the
port's CLI (``cli.main``)."""

from multimodal_organ_segmentation_tpu_torch.cli import main

if __name__ == "__main__":
    main()
