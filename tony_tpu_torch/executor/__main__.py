"""``python -S -m tony_tpu_torch.executor`` — the port's container entry
point (reference:
``TaskExecutor.main``, launched by the NM per ``buildContainerLaunchContext``)."""

import sys

from tony_tpu_torch.util import restore_site_dirs

restore_site_dirs()   # -S entry: see tony_tpu_torch.util.ENV_SITE_DIRS

from tony_tpu_torch.executor import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
