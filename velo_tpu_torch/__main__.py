"""``python -m velo_tpu_torch`` runs the command line (``cli.main``)."""
from velo_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
