"""``python -m repro_torch.dse.service`` — run the DSE daemon."""
from repro_torch.dse.service.server import main

if __name__ == "__main__":
    raise SystemExit(main())
