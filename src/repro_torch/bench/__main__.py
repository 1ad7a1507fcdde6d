"""``python -m repro_torch.bench``: see :mod:`repro_torch.bench.run`."""
from repro_torch.bench.run import main

raise SystemExit(main())
