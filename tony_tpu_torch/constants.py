"""The names the port's training and serving planes share with the TonY
control plane: a copy of the entries of :mod:`tony_tpu.constants` they
read (the port imports nothing of the JAX package).
``tests/test_torch_train_loop.py`` and ``tests/test_torch_purity.py``
hold every value equal to the original."""

# The executor's env contract with a task: its jobtype and the job conf
# the AM serialized (the serve replica reads the conf, and its role and
# warm-standby keys by jobtype).
ENV_JOB_NAME = "TONY_JOB_NAME"
ENV_CONF_PATH = "TONY_CONF_PATH"

# Checkpoint plane (tony_tpu_torch.ckpt): train_loop reads these as the
# defaults of its checkpoint directory, save interval and retention.
ENV_CKPT_DIR = "TONY_CKPT_DIR"
ENV_CKPT_EVERY = "TONY_CKPT_EVERY"
ENV_CKPT_KEEP = "TONY_CKPT_KEEP"
# Input-data plane (tony_tpu_torch.data): the gang's shared stream seed
# (Dataset's default), and the two env pairs ShardSpec.from_env reads, the
# rendezvous pair first.
ENV_DATA_SEED = "TONY_DATA_SEED"
ENV_PROCESS_ID = "TONY_PROCESS_ID"
ENV_NUM_PROCESSES = "TONY_NUM_PROCESSES"
ENV_TASK_INDEX = "TONY_TASK_INDEX"
ENV_TASK_NUM = "TONY_NUM_TASKS"
# The executor's per-container stats file; train_stats_writer publishes
# each step's telemetry there and the heartbeat carries it to the AM.
ENV_SERVE_STATS = "TONY_SERVE_STATS"
# The executor's drain flag (elastic resize): train_loop polls it between
# steps and exits EXIT_DRAINED.
ENV_DRAIN_FILE = "TONY_DRAIN_FILE"
# Continuous publication: train_loop advances the checkpoint root's
# published.json pointer every N committed periodic saves.
ENV_PUBLISH_EVERY = "TONY_PUBLISH_EVERY"
# Shared per-gang train AOT cache dir (tony_tpu_torch.ckpt.aot), from
# tony.train.aot-cache: train.shared_aot_cache reads it.
ENV_TRAIN_AOT_CACHE = "TONY_TRAIN_AOT_CACHE"

# The history plane's event-log layout (tony_tpu_torch.events reads it):
# <history>/intermediate/<appId>.jhist.inprogress while a job runs,
# <history>/finished/<appId>.jhist after.
EVENTS_DIR_INTERMEDIATE = "intermediate"
EVENTS_DIR_FINISHED = "finished"
JHIST_SUFFIX = ".jhist"
JHIST_INPROGRESS_SUFFIX = ".jhist.inprogress"

# The PyTorchRuntime's rendezvous env (runtime/pytorch_runtime.py).
ENV_MASTER_ADDR = "MASTER_ADDR"
ENV_MASTER_PORT = "MASTER_PORT"
ENV_RANK = "RANK"
ENV_WORLD_SIZE = "WORLD_SIZE"
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_INIT_METHOD = "INIT_METHOD"

EXIT_DRAINED = 14           # clean drain exit (elastic resize commit)
