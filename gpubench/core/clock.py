"""Timing of one request: CUDA events in the step callback, host spans.

The step callback records an event and keeps the step's latents (a copy on
the device, for the comparison after the window, which the runner drops
unless the request is sampled); it never synchronizes,
so a host that falls behind shows as a longer step.  Step 0 is timed from
an event recorded just before the pipeline call (it includes the text
encoders); step i from the event of step i - 1.  Host spans use the
monotonic clock around work that ends on the host (a copy to host memory
or a file written), and open a ``record_function`` range of the same name
so that a profiled run can label what the host was doing.
"""

import time
from contextlib import contextmanager
from typing import Dict, List

import torch


class RequestClock:
    def __init__(self, device):
        self.timed = torch.device(device).type == 'cuda'
        self.start = None
        self.events: List = []
        self.after_call = None
        self.latents: List[torch.Tensor] = []
        self.spans: Dict[str, List[float]] = {}

    def _event(self):
        if not self.timed:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def begin(self):
        self.start = self._event()

    def on_step(self, i, t, latents):
        self.events.append(self._event())
        self.latents.append(latents.clone())

    def end_call(self):
        self.after_call = self._event()

    @contextmanager
    def span(self, name: str):
        t0 = time.monotonic()
        with torch.profiler.record_function(f'gpubench.{name}'):
            yield
        self.spans.setdefault(name, []).append(time.monotonic() - t0)

    def step_ms(self) -> List[float]:
        """Each step's milliseconds; call once the request has finished."""
        if not self.timed:
            return []
        marks = [self.start] + self.events
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    def decode_ms(self) -> float:
        """From the last step's end to the images on the host."""
        return self.events[-1].elapsed_time(self.after_call)
