"""``python -m repro_torch.analysis``: lint + structure-check CLI (CI analyze gate)."""

from repro_torch.analysis.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
