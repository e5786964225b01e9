"""PTT (push-to-talk) GPIO boundary.

Reference: rpi_gpio.cpp -- sysfs GPIO with PTT output on pin 10 and a
PTT input (hardware key) on pin 11 (rpi_gpio.cpp:10-11): export the
pin, set direction, write/read the value file (pin_export/
pin_direction/pin_set_value/pin_read_value, rpi_gpio.cpp:14-98), with
rpi_set_ptt/rpi_clear_ptt/rpi_read_ptt on top (rpi_gpio.cpp:100-117).

This keeps the same sysfs contract when /sys/class/gpio exists (or any
substitute root, for tests), and degrades to an in-memory stub
otherwise, so the session layer drives one interface everywhere.

The port's own copy of ``m17_sdr_tpu.io.ptt``: the port imports nothing of the
JAX package, so it keeps copies of the modules it needs from it.
"""

from __future__ import annotations

import os

PTT_OUT = 10   # rpi_gpio.cpp:10
PTT_IN = 11    # rpi_gpio.cpp:11


class SysfsGpio:
    """Minimal sysfs GPIO pin access (rpi_gpio.cpp:14-98)."""

    def __init__(self, root: str = "/sys/class/gpio"):
        self.root = root

    def _write(self, path: str, text: str) -> bool:
        try:
            with open(path, "w") as f:
                f.write(text)
            return True
        except OSError:
            return False

    def export(self, pin: int) -> bool:
        if os.path.isdir(f"{self.root}/gpio{pin}"):
            return True
        return self._write(f"{self.root}/export", str(pin))

    def unexport(self, pin: int) -> bool:
        return self._write(f"{self.root}/unexport", str(pin))

    def direction(self, pin: int, direction: str) -> bool:
        return self._write(f"{self.root}/gpio{pin}/direction", direction)

    def set_value(self, pin: int, value: int) -> bool:
        return self._write(f"{self.root}/gpio{pin}/value", str(int(value)))

    def read_value(self, pin: int) -> int | None:
        try:
            with open(f"{self.root}/gpio{pin}/value") as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return None


class Ptt:
    """PTT facade: sysfs-backed when available, in-memory otherwise.

    set()/clear() drive the transmit key (rpi_set_ptt/rpi_clear_ptt);
    read() samples the hardware PTT input (rpi_read_ptt: pressed when
    the pin reads low, rpi_gpio.cpp:108-117).
    """

    def __init__(self, root: str = "/sys/class/gpio",
                 out_pin: int = PTT_OUT, in_pin: int = PTT_IN):
        self.out_pin = out_pin
        self.in_pin = in_pin
        self._state = False
        self._gpio: SysfsGpio | None = None
        if os.path.isdir(root):
            gpio = SysfsGpio(root)
            if (gpio.export(out_pin) and gpio.direction(out_pin, "out")
                    and gpio.export(in_pin) and gpio.direction(in_pin, "in")):
                self._gpio = gpio

    @property
    def hardware(self) -> bool:
        return self._gpio is not None

    def set(self) -> None:
        self._state = True
        if self._gpio:
            self._gpio.set_value(self.out_pin, 1)

    def clear(self) -> None:
        self._state = False
        if self._gpio:
            self._gpio.set_value(self.out_pin, 0)

    def get(self) -> bool:
        return self._state

    def read(self) -> bool:
        """Hardware PTT key state; active-low (rpi_gpio.cpp:108-117)."""
        if self._gpio:
            val = self._gpio.read_value(self.in_pin)
            if val is not None:
                return val == 0
        return False

    def close(self) -> None:
        if self._gpio:
            self._gpio.unexport(self.out_pin)
            self._gpio.unexport(self.in_pin)
            self._gpio = None
