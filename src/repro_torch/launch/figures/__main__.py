"""``python -m repro_torch.launch.figures``: the figure harness
(``launch.figures.run``)."""

from repro_torch.launch.figures.run import main

if __name__ == "__main__":
    raise SystemExit(main())
