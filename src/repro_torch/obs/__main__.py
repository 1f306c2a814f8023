"""``python -m repro_torch.obs``: record paper workloads as Perfetto traces."""

from repro_torch.obs.viewer import main

raise SystemExit(main())
