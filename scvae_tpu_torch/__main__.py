"""``python -m scvae_tpu_torch`` entry point (the port of
``scvae_tpu/__main__.py``)."""

from scvae_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
