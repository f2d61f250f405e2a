"""Time-step controller.

Behavioral parity with the reference's TimeStepping
(source/time_stepping.cc): schemes implicit/explicit Euler,
Crank-Nicolson and BDF-2; variable-step BDF-2 weights (cc:158-173),
extrapolation factors (cc:182-193), `next()` hitting the end time exactly
(cc:141-156), `set_desired_time_step` clamping to [1/2, 2]x the previous step
and to [min, max] (cc:251-269), and the `at_tick` output cadence (cc:228-238).

This is host-side control logic (plain Python floats); the weights feed the
jitted device kernels as scalars.
"""

from __future__ import annotations


from adaflo_tpu_torch.parameters import Scheme as TimeSteppingScheme
from adaflo_tpu_torch.parameters import TimeSteppingParameters


class TimeStepping:
    def __init__(self, parameters) -> None:
        # accept either FlowParameters or TimeSteppingParameters
        if not isinstance(parameters, TimeSteppingParameters):
            parameters = parameters.time_stepping_parameters()
        p = parameters
        self._start = p.start_time
        self._final = p.end_time
        self._scheme = p.time_step_scheme
        self._start_step = p.time_step_size_start
        self._max_step = p.time_step_size_max
        self._min_step = p.time_step_size_min
        self._current_step = self._start_step
        self._last_step = 0.0
        self._step = self._start_step
        self._weight = 1.0 / self._start_step
        self._weight_old = -1.0
        self._weight_old_old = 0.0
        self._factor_extrapol_old = 0.0
        self._factor_extrapol_old_old = 0.0
        self._step_no = 0
        self._at_end = False
        self._weight_changed = True
        self._now = self._start
        self._prev = self._start
        if self._scheme == TimeSteppingScheme.implicit_euler:
            self._tau1, self._tau2 = 1.0, 0.0
        elif self._scheme == TimeSteppingScheme.explicit_euler:
            self._tau1, self._tau2 = 0.0, 1.0
        elif self._scheme == TimeSteppingScheme.crank_nicolson:
            self._tau1 = self._tau2 = 0.5
        elif self._scheme == TimeSteppingScheme.bdf_2:
            self._tau1, self._tau2 = 1.0, 0.0

    # -- getters (reference: time_stepping.h:192-295) ----------------------
    def start(self) -> float:
        return self._start

    def final(self) -> float:
        return self._final

    def step_size(self) -> float:
        return self._current_step

    def max_step_size(self) -> float:
        return self._max_step

    def old_step_size(self) -> float:
        return self._last_step

    def now(self) -> float:
        return self._now

    def previous(self) -> float:
        return self._prev

    def tau1(self) -> float:
        return self._tau1

    def tau2(self) -> float:
        return self._tau2

    def step_no(self) -> int:
        return self._step_no

    def weight(self) -> float:
        return self._weight

    def max_weight_uniform(self) -> float:
        if self._scheme == TimeSteppingScheme.bdf_2:
            return 1.5 / self._current_step
        return 1.0 / self._current_step

    def weight_old(self) -> float:
        return self._weight_old

    def weight_old_old(self) -> float:
        return self._weight_old_old

    def weight_has_changed(self) -> bool:
        return self._weight_changed

    def at_end(self) -> bool:
        return self._at_end

    def scheme(self) -> TimeSteppingScheme:
        return self._scheme

    def name(self) -> str:
        return {
            TimeSteppingScheme.implicit_euler: "ImplEuler",
            TimeSteppingScheme.explicit_euler: "ExplEuler",
            TimeSteppingScheme.crank_nicolson: "CrankNicolson",
            TimeSteppingScheme.bdf_2: "BDF-2",
        }[self._scheme]

    def extrapolate(self, old, old_old):
        return old * self._factor_extrapol_old + old_old * self._factor_extrapol_old_old

    @property
    def extrapolation_factors(self) -> tuple[float, float]:
        return self._factor_extrapol_old, self._factor_extrapol_old_old

    # -- control -----------------------------------------------------------
    def restart(self) -> None:
        self._step_no = 0
        self._now = self._start
        self._step = self._start_step
        self._current_step = self._step
        self._last_step = 0.0
        self._at_end = (self._final - self._start) / self._start_step < 1e-14
        self._weight_changed = True

    def next(self) -> float:
        """Advance one step; may adjust the step to hit the final time exactly
        (reference cc:123-200)."""
        assert not self._at_end, "Final time already reached, cannot proceed"
        s = self._current_step

        if self._now != self._start:
            self._last_step = self._current_step
            if self._scheme == TimeSteppingScheme.bdf_2 and self._step_no == 1:
                s = self._step
            if s > self._max_step:
                s = self._max_step

        h = self._now + s
        self._current_step = s

        # if we just missed the final time, stretch the step to land exactly
        s1 = 0.01 * s
        if not self._at_end and h > self._final - s1:
            self._current_step = self._final - self._now
            h = self._final
            self._at_end = True

        if self._scheme == TimeSteppingScheme.bdf_2 and self._now != self._start:
            k, k_old = self._current_step, self._last_step
            new_weight = (2.0 * k + k_old) / (k * (k + k_old))
            self._weight_old = -((k + k_old) / (k * k_old))
            self._weight_old_old = k / (k_old * (k + k_old))
        else:
            new_weight = 1.0 / self._current_step
            self._weight_old = -1.0 / self._current_step

        if abs(new_weight - self._weight) / new_weight > 1e-12:
            self._weight = new_weight
            self._weight_changed = True
        else:
            self._weight_changed = False

        # extrapolation weights; skip in second step since the initial
        # condition might not be consistent
        if self._step_no > 1:
            self._factor_extrapol_old = (
                self._current_step + self._last_step
            ) / self._last_step
            self._factor_extrapol_old_old = -self._current_step / self._last_step
        else:
            self._factor_extrapol_old = 1.0
            self._factor_extrapol_old_old = 0.0

        self._prev = self._now
        self._now = h
        self._step_no += 1
        return self._now

    def at_tick(self, tick: float) -> bool:
        time = self.now()
        position = int(time * 1.0000000001 / tick)
        slot = position * tick
        if (time - slot) > (self.step_size() * 0.95) and not self.at_end():
            return False
        return True

    def set_time_step(self, value: float) -> None:
        self._current_step = value
        self._step = value

    def set_desired_time_step(self, desired_value: float) -> None:
        step_size_prev = desired_value if self._now == 0 else self.step_size()
        self._current_step = min(
            2 * step_size_prev, max(desired_value, 0.5 * step_size_prev)
        )
        self._current_step = min(
            self._max_step, max(self._min_step, self._current_step)
        )
        self._step = self._current_step

    def set_start_time(self, t: float) -> None:
        self._start = t

    def set_final_time(self, t: float) -> None:
        self._final = t
