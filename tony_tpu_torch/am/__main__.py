"""``python -S -m tony_tpu_torch.am`` — the port's standalone AM process (reference:
``TonyApplicationMaster.main``, launched in the AM container by the RM on the
client's behalf — SURVEY.md §3.1)."""

import argparse
import signal
import sys

from tony_tpu_torch.util import restore_site_dirs

restore_site_dirs()   # -S entry: see tony_tpu_torch.util.ENV_SITE_DIRS

from tony_tpu_torch.am import ApplicationMaster  # noqa: E402
from tony_tpu_torch.conf import TonyConfig  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tony-am")
    p.add_argument("--conf", required=True, help="serialized job config")
    p.add_argument("--app-id", required=True)
    p.add_argument("--job-dir", required=True)
    p.add_argument("--host", default="127.0.0.1",
                   help="address executors use to reach the AM RPC")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    conf = TonyConfig.load(args.conf)
    am = ApplicationMaster(conf, app_id=args.app_id, job_dir=args.job_dir,
                           host=args.host, quiet=not args.verbose)
    # Graceful SIGTERM (client kill fallback): drain through the AM's normal
    # teardown instead of dying mid-loop and orphaning executor groups.
    signal.signal(signal.SIGTERM,
                  lambda _sig, _frm: am.request_stop("AM received SIGTERM"))
    try:
        return am.run()
    except Exception as e:  # noqa: BLE001 — AM-internal failure, not job's
        from tony_tpu_torch import constants
        print(f"[tony-am] internal error: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return constants.EXIT_AM_ERROR


if __name__ == "__main__":
    sys.exit(main())
