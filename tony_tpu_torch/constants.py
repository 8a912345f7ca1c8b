"""The names the port's training plane shares with the TonY control plane:
a copy of the entries of :mod:`tony_tpu.constants` it reads (the port
imports nothing of the JAX package). ``tests/test_torch_train_loop.py``
holds every value equal to the original."""

# Checkpoint plane: train_loop reads these as its defaults (the resume
# they ask for lands with the checkpoint slice, ROADMAP.md queue 1
# item 3; until then setting one raises).
ENV_CKPT_DIR = "TONY_CKPT_DIR"
ENV_CKPT_EVERY = "TONY_CKPT_EVERY"
# The executor's per-container stats file; train_stats_writer publishes
# each step's telemetry there and the heartbeat carries it to the AM.
ENV_SERVE_STATS = "TONY_SERVE_STATS"
# The executor's drain flag (elastic resize): train_loop polls it between
# steps and exits EXIT_DRAINED.
ENV_DRAIN_FILE = "TONY_DRAIN_FILE"
# Continuous publication every N committed saves (checkpoint slice).
ENV_PUBLISH_EVERY = "TONY_PUBLISH_EVERY"

# The PyTorchRuntime's rendezvous env (runtime/pytorch_runtime.py).
ENV_MASTER_ADDR = "MASTER_ADDR"
ENV_MASTER_PORT = "MASTER_PORT"
ENV_RANK = "RANK"
ENV_WORLD_SIZE = "WORLD_SIZE"
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_INIT_METHOD = "INIT_METHOD"

EXIT_DRAINED = 14           # clean drain exit (elastic resize commit)
