"""Model refresh with no dropped requests: generation polling -> hot swap.

The deployment loop the ROADMAP's north star asks for: a trainer (or a
sweep session) keeps writing new checkpoints; the serving process picks
each one up without dropping a request and without restarting.

The contract is split across three layers so each piece stays simple:

  checkpoint/io.py  owns the **generation counter** — every fresh write
                    into a directory publishes `prior + 1`, and
                    `checkpoint_generation()` only ever reports *servable*
                    checkpoints (a streaming manifest that has not flipped
                    `complete` reads as None). A half-written model is
                    therefore invisible here by construction.
  serve/server.py   owns the **swap** — `XMCServer.refresh_from(dir)` loads
                    the replacement, warms it off-thread and flips the
                    reference between micro-batches (see `swap`'s
                    docstring for the state machine).
  this module       owns the **watching**: `CheckpointWatcher` polls the
                    generation counter and calls swap when it moves.

`ModelRouter.watch(name, dir)` attaches a watcher to a routed server and
`launch/serve.py --watch` exposes the whole loop on the CLI. Rollback
needs no machinery: the server retains `previous_engine`, so
`server.swap(server.previous_engine)` is the rollback.

A port of the JAX package's module of the same name. The new engine is
opened on the device the server serves on.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from repro_torch.checkpoint.io import checkpoint_generation


class CheckpointWatcher:
    """Poll one out_dir's generation counter; hot-swap a server on change.

    Polling (not inotify) on purpose: checkpoints land on shared/remote
    filesystems where event APIs are unreliable, and the poll is two small
    JSON reads. Each `poll_once()`:

      1. reads `checkpoint_generation(directory)` — None (nothing servable
         yet / stream mid-write) never triggers anything, which is the
         "never swap a half-written generation" guarantee;
      2. on a generation newer than the last one seen, hands the
         directory to `server.refresh_from`, which opens it strictly on
         the server's device, builds the engine its spec (or
         `serve_override`) describes and swaps it in — the old model
         serves until the new one is warm.

    The constructor samples the directory's current generation as the
    baseline (the server was just built from it); pass
    `swap_existing=True` to treat whatever is on disk as new, e.g. when
    the server started on a different checkpoint.

    `start()` runs the poll on a daemon thread every `poll_interval_s`;
    `stop()` joins it. `poll_once()` is public so tests and cron-style
    callers can drive the loop deterministically. A poll that fails on
    the checkpoint or the swap's checks (a checkpoint vanished or torn
    mid-read: OSError, ValueError, KeyError; a feature-dim mismatch:
    ValueError) stores the exception on `last_error` and keeps watching —
    a broken nightly build must not kill the serving process. Any other
    error, a kernel or device fault among them, is stored on `last_error`
    and `error` and raised: the watcher's thread ends there, and `stop()`
    raises it (so `ModelRouter.stop()` does too) rather than let the
    process serve on with a dead watcher unreported.
    """

    def __init__(self, directory: str, server, *,
                 serve_override=None,
                 poll_interval_s: float = 2.0,
                 swap_existing: bool = False,
                 on_swap: Optional[Callable] = None):
        if poll_interval_s <= 0:
            raise ValueError(f"poll_interval_s must be > 0, got "
                             f"{poll_interval_s}")
        self.directory = directory
        self.server = server
        self.serve_override = serve_override
        self.poll_interval_s = float(poll_interval_s)
        self.on_swap = on_swap
        self.generation = (None if swap_existing
                           else checkpoint_generation(directory))
        self.last_error: Optional[BaseException] = None
        self.error: Optional[BaseException] = None   # the fault that ended it
        self.swaps = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self):
        """One poll step: swap if a newer finalized generation landed.
        Returns the new `CheckpointHandle` on a swap, else None."""
        try:
            gen = checkpoint_generation(self.directory)
            if gen is None or (self.generation is not None
                               and gen <= self.generation):
                return None
            handle, prev = self.server.refresh_from(
                self.directory, serve_override=self.serve_override)
            self.generation = gen
            self.swaps += 1
            self.last_error = None
            if self.on_swap is not None:
                self.on_swap(gen, handle, prev)
            return handle
        except (OSError, ValueError, KeyError) as e:
            self.last_error = e
            return None
        except Exception as e:
            self.last_error = self.error = e
            raise

    # -- background thread ------------------------------------------------

    def start(self) -> "CheckpointWatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name=f"ckpt-watch-{self.directory}",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception:         # kept on `error`; stop() raises it
                return

    def stop(self) -> None:
        """Join the polling thread; raise the fault that ended it, if
        one did."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            raise RuntimeError(f"checkpoint watcher of {self.directory!r} "
                               f"failed") from self.error

    def __enter__(self) -> "CheckpointWatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
