"""Shared constants of the port: env-var names, file names, well-known
job types and exit codes — a copy of :mod:`tony_tpu.constants` (the port
imports nothing of the JAX package), which mirrors the role of
``com.linkedin.tony.Constants``: the one place where the env-var contract
between the AM, the task executors and user code is written down.

Kept: every name the port's control plane, training and serving planes
read. Left out: the TensorFlow, Horovod, MXNet, libtpu, megascale and
XLA rendezvous env, which no port runtime exports. Added: the CUDA
seams of the port's ``PyTorchRuntime`` (``CUDA_VISIBLE_DEVICES``,
``TONY_TASK_GPUS`` and NCCL's async error handling).
``tests/test_torch_purity.py`` holds every shared value equal to the
original.
"""

# --- Environment contract: AM -> TaskExecutor -------------------------------
# (reference: Constants.JOB_NAME / TASK_INDEX / AM_HOST / AM_PORT etc., set in
#  TonyApplicationMaster#buildContainerLaunchContext)
ENV_JOB_NAME = "TONY_JOB_NAME"              # jobtype, e.g. "worker", "ps", "chief"
ENV_TASK_INDEX = "TONY_TASK_INDEX"          # integer index within the jobtype
ENV_TASK_NUM = "TONY_NUM_TASKS"             # total number of tasks in the job
ENV_AM_ADDRESS = "TONY_AM_ADDRESS"          # host:port of the AM ApplicationRpc
ENV_APP_ID = "TONY_APP_ID"                  # application id, e.g. "app_1700000000_0001"
ENV_ATTEMPT_ID = "TONY_ATTEMPT_ID"          # AM attempt ordinal (gang restart)
ENV_CONF_PATH = "TONY_CONF_PATH"            # path to the serialized job config
ENV_CONTAINER_ID = "TONY_CONTAINER_ID"      # container id for this executor
ENV_LOG_DIR = "TONY_LOG_DIR"                # directory for executor+user logs
ENV_SRC_DIR = "TONY_SRC_DIR"                # localized user source directory
ENV_VENV = "TONY_VENV"                      # localized virtualenv (optional)
ENV_RESOURCES_DIR = "TONY_RESOURCES_DIR"    # staged tony.containers.resources
ENV_SUBMIT_TS = "TONY_SUBMIT_TS"            # client submit wall-clock (epoch s)

# --- Environment contract: TaskExecutor -> user process ---------------------
# (reference: MLGenericRuntime common env + per-runtime additions)
ENV_JOB_TYPE = "JOB_NAME"                   # TonY exports JOB_NAME/TASK_INDEX too
ENV_TASK_INDEX_USER = "TASK_INDEX"
ENV_DIST_SPEC = "CLUSTER_SPEC"              # JSON {jobtype: ["host:port", ...]}
ENV_TB_PORT = "TB_PORT"                     # reserved TensorBoard port (chief/tb)

# The JAX rendezvous pair, which ShardSpec.from_env reads before the
# generic executor pair (a port job gets the executor pair).
ENV_PROCESS_ID = "TONY_PROCESS_ID"
ENV_NUM_PROCESSES = "TONY_NUM_PROCESSES"
# Checkpoint plane (tony_tpu_torch.ckpt): PyTorchRuntime exports these
# from tony.ckpt.dir/every/keep; train_loop reads them as its defaults,
# and the executor scans the same dir to report the last COMMITTED step
# over the heartbeat RPC.
ENV_CKPT_DIR = "TONY_CKPT_DIR"
ENV_CKPT_EVERY = "TONY_CKPT_EVERY"
ENV_CKPT_KEEP = "TONY_CKPT_KEEP"
# Input-data plane (tony_tpu_torch.data): PyTorchRuntime exports
# tony.data.seed so the whole gang derives the SAME deterministic example stream without the
# script threading a seed through (Dataset's default seed). The shard
# itself needs no new env — ShardSpec.from_env reads the rendezvous pair
# (TONY_PROCESS_ID/TONY_NUM_PROCESSES) with the generic executor pair
# (TONY_TASK_INDEX/TONY_NUM_TASKS) as fallback.
ENV_DATA_SEED = "TONY_DATA_SEED"
# Serving plane (tony_tpu_torch.serve): the executor exports a
# per-container stats-file path; the replica's engine publishes qps/p99/queue-depth
# there and the executor's heartbeat loop piggybacks it to the AM (both
# sides torch-free), where the replica autoscaler reads it.
ENV_SERVE_STATS = "TONY_SERVE_STATS"
# Elastic resize (the reference AM's tony_tpu.am.resize; the drain file
# also ends a port job cleanly): the executor exports a drain-file path; when the AM's heartbeat response carries the drain directive the
# executor creates the file, and train_loop — polling it between steps —
# commits model+data-cursor and exits EXIT_DRAINED.
ENV_DRAIN_FILE = "TONY_DRAIN_FILE"
# Continuous weight publication (tony_tpu_torch.publish): PyTorchRuntime
# exports tony.publish.every; train_loop advances the ckpt root's published.json
# pointer every N committed periodic saves, and the executor's heartbeat
# loop reads the pointer (torch-free) and announces it to the AM.
ENV_PUBLISH_EVERY = "TONY_PUBLISH_EVERY"
# Shared per-gang train AOT cache dir (tony_tpu_torch.ckpt.aot): exported
# from tony.train.aot-cache; make_accum_train_step deserializes a gang mate's
# compiled step instead of re-tracing (first writer wins on populate).
ENV_TRAIN_AOT_CACHE = "TONY_TRAIN_AOT_CACHE"

# PyTorchRuntime rendezvous (c10d TCP store; torch.distributed).
ENV_MASTER_ADDR = "MASTER_ADDR"
ENV_MASTER_PORT = "MASTER_PORT"
ENV_RANK = "RANK"
ENV_WORLD_SIZE = "WORLD_SIZE"
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_INIT_METHOD = "INIT_METHOD"

# CUDA seams of the port's PyTorchRuntime. A task that asks for
# tony.<jobtype>.gpus = g > 0 sees exactly its g cards of the host
# (CUDA_VISIBLE_DEVICES, the JAX runtime's TPU_VISIBLE_DEVICES rule), and
# TONY_TASK_GPUS = g tells tony_tpu_torch.distributed that TonY pinned it:
# a pinned task uses its first visible card, an unpinned one
# cuda:{LOCAL_RANK}. CUDA_DEVICE_ORDER=PCI_BUS_ID makes those indices
# nvidia-smi's (the GPU census's) instead of CUDA's fastest-first order.
# NCCL's async error handling makes a dead peer end the gang instead of
# hanging it (tony.<jobtype>.env overrides it).
ENV_CUDA_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
ENV_CUDA_DEVICE_ORDER = "CUDA_DEVICE_ORDER"
ENV_TASK_GPUS = "TONY_TASK_GPUS"
ENV_NCCL_ASYNC_ERROR_HANDLING = "TORCH_NCCL_ASYNC_ERROR_HANDLING"

# --- Well-known job types ---------------------------------------------------
# (reference: open-ended; these are the conventional names used by the success
#  policy in TonyApplicationMaster / TonySession)
CHIEF = "chief"
MASTER = "master"
PS = "ps"
WORKER = "worker"
EVALUATOR = "evaluator"
TENSORBOARD = "tensorboard"
NOTEBOOK = "notebook"
DRIVER = "driver"               # Horovod-style driver task
SCHEDULER = "scheduler"         # MXNet kvstore scheduler
SERVE = "serve"                 # online-serving replica (tony_tpu_torch.serve)

# Job types whose completion drives the "chief done => job done" policy.
CHIEF_LIKE_JOB_TYPES = (CHIEF, MASTER)

# Sidecar job types: never part of the ML rendezvous world (excluded from
# RANK/WORLD_SIZE/coordinator selection the way the reference's TFRuntime
# excludes them from TF_CONFIG). Distinct from *untracked* types: ``ps`` is
# untracked by default but IS a cluster member.
SIDECAR_JOB_TYPES = (TENSORBOARD, NOTEBOOK, DRIVER)

# --- File-layout conventions ------------------------------------------------
TONY_XML = "tony.xml"                       # user config file name (compat)
TONY_JOB_JSON = "tony-job.json"             # serialized effective config
JHIST_SUFFIX = ".jhist"                     # history file (JSONL here, Avro in ref)
JHIST_INPROGRESS_SUFFIX = ".jhist.inprogress"
EVENTS_DIR_INTERMEDIATE = "intermediate"    # AM writes here while running
EVENTS_DIR_FINISHED = "finished"            # moved here on completion
EXECUTOR_LOG_NAME = "executor.log"
USER_STDOUT_NAME = "stdout.log"
USER_STDERR_NAME = "stderr.log"

# --- Exit codes (reference: TaskExecutor / TonyClient contract) -------------
EXIT_SUCCESS = 0
EXIT_FAILURE = 1
EXIT_AM_ERROR = 10          # AM internal error
EXIT_LOST_TASK = 11         # task lost to missed heartbeats
EXIT_PREEMPTED = 12         # container preempted by the scheduler
EXIT_KILLED = 13            # killed by client / untracked-task teardown
EXIT_DRAINED = 14           # clean drain exit (elastic resize commit)
