"""Multi-host start and the checkpoint-restart loop, the port of the JAX
package's `parallel/multihost.py`.

Each process of a multi-host run calls `initialize_multihost()` before it
builds a mesh. It joins the `torch.distributed` process group from its
arguments or from the environment `torchrun` sets (MASTER_ADDR and
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK); after that `make_mesh()` lays
out every rank of the job. The JAX package's TPU-only probes
(`TPU_WORKER_HOSTNAMES`, `MEGASCALE_COORDINATOR_ADDRESS`) have no
counterpart here.

Recovery is checkpoint-restart, as in the JAX package: `run_with_restarts`
calls a training function again after a transient failure, and the function
resumes from its newest checkpoint (`train/train_loop.py::train` with
`checkpoint_dir`). A lost host means a restarted job; there is no elastic
resize.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

# transient failures retried besides RuntimeError, OSError and
# ConnectionError, matched by class name anywhere in the exception's MRO
# (RPC-layer errors that subclass none of the three)
TRANSIENT_NAMES = ("RpcError", "InternalError", "UnavailableError",
                   "DeadlineExceededError", "AbortedError")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> bool:
    """Join the job's process group: NCCL when `device` is a CUDA device
    (this process's card is LOCAL_RANK), gloo for the CPU. Each setting
    comes from its argument, else from the environment `torchrun` sets;
    the coordinator is "host:port" (MASTER_ADDR:MASTER_PORT). Returns False,
    doing nothing, when no coordinator is configured (the single-process
    case), True after the group is initialised."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return False
    world = (num_processes if num_processes is not None
             else int(env.get("WORLD_SIZE", "1")))
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device is available "
                               "(pass device='cpu' for a gloo group)")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    print(f"torch.distributed: {backend} rank {rank}/{world} via "
          f"{coordinator_address}", file=sys.stderr)
    return True


def is_transient(e: BaseException) -> bool:
    """Whether `run_with_restarts` retries `e`: RuntimeError (which
    `torch.distributed`'s DistError family, NCCL and CUDA runtime errors
    subclass), OSError (checkpoint I/O), ConnectionError, or a class named
    in TRANSIENT_NAMES. Anything else is deterministic (a shape or config
    error) and fails the same way on every attempt."""
    return (isinstance(e, (RuntimeError, OSError, ConnectionError))
            or any(c.__name__ in TRANSIENT_NAMES for c in type(e).__mro__))


def run_with_restarts(
    train_fn: Callable[[Optional[str]], object],
    checkpoint_dir: Optional[str] = None,
    max_restarts: int = 3,
    backoff_s: float = 10.0,
):
    """Call `train_fn(checkpoint_dir)`; after a transient failure
    (`is_transient`) call it again, up to `max_restarts` times, waiting
    backoff_s · attempt seconds first. A deterministic error and
    KeyboardInterrupt are raised at once, and the last failure is raised
    when the restarts are spent. `train_fn` resumes from the newest
    checkpoint in `checkpoint_dir` and saves as it goes."""
    attempt = 0
    while True:
        try:
            return train_fn(checkpoint_dir)
        except Exception as e:  # noqa: BLE001 — sorted by is_transient
            if not is_transient(e):
                raise
            attempt += 1
            if attempt > max_restarts:
                raise
            print(f"training attempt {attempt} failed ({type(e).__name__}: "
                  f"{e}); restarting from checkpoint in "
                  f"{backoff_s * attempt:.0f}s", file=sys.stderr)
            time.sleep(backoff_s * attempt)
