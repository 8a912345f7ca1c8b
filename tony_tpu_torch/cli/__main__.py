"""``python -m tony_tpu_torch.cli`` — the port's ``tony`` entry point
(reference: ``ClusterSubmitter.main`` via the ``tony-cli`` shadow jar)."""

import sys

from tony_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
