"""``python -m repro_torch.analysis`` — see cli.py for flags and exit codes.

Copy of ``repro.analysis.__main__``, guarded so that importing it runs
nothing."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
