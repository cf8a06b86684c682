"""`python -m cruise_control_torch.lint`: the port's linter command line."""

from cruise_control_torch.lint.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
