"""What a traffic kind is given: the cell, its configuration, the run's
arguments, the device, and the clock of the run."""

from __future__ import annotations

import gc
import time



class RunContext:
    def __init__(self, *, config: dict, cell: dict, seed: int,
                 seconds: float, trace: bool, device: str, t_start: float,
                 program: str = "port"):
        import torch
        self.config, self.cell = config, cell
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t_start = t_start
        self.program = program
        self.setup_s = None

    def generator(self):
        """The run's generator on the device, seeded with ``--seed``."""
        import torch
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        return g

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def mark_setup(self) -> None:
        """Set-up ends here: from process start to the first timed call.
        What set-up made is moved out of the collector's sight
        (``gc.freeze``), so that its passes in the window stay short."""
        gc.collect()
        gc.freeze()
        self.setup_s = self.now() - self.t_start

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        import torch
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            import torch
            torch.cuda.empty_cache()
