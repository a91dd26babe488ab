"""AppSettings: INI persistence (~/.config/ultra/settings.ini).

Reference: src/gui/widgets/settings.cpp + docs/CONFIGURATION_SYSTEM.md:9-80.
Three config layers: (1) ModemConfig presets (config.py), (2) these persisted
app settings incl. expert-mode forced waveform/mod/rate (0xFF = AUTO),
(3) per-connection negotiated mode (protocol.connection).

The port's copy of the JAX package's module, pinned to it by
``tests/test_torch_aux.py``.
"""

from __future__ import annotations

import configparser
import dataclasses
import os

AUTO = 0xFF
DEFAULT_PATH = os.path.expanduser("~/.config/ultra/settings.ini")


@dataclasses.dataclass
class AppSettings:
    callsign: str = "N0CALL"
    auto_accept: bool = True
    receive_dir: str = "."
    audio_input_device: str = ""
    audio_output_device: str = ""
    # Expert mode (0xFF = AUTO).
    forced_waveform: int = AUTO
    forced_modulation: int = AUTO
    forced_code_rate: int = AUTO
    log_level: str = "WARN"

    def save(self, path: str = DEFAULT_PATH):
        cp = configparser.ConfigParser()
        cp["station"] = {
            "callsign": self.callsign,
            "auto_accept": str(int(self.auto_accept)),
            "receive_dir": self.receive_dir,
        }
        cp["audio"] = {
            "input_device": self.audio_input_device,
            "output_device": self.audio_output_device,
        }
        cp["expert"] = {
            "forced_waveform": f"0x{self.forced_waveform:02X}",
            "forced_modulation": f"0x{self.forced_modulation:02X}",
            "forced_code_rate": f"0x{self.forced_code_rate:02X}",
        }
        cp["debug"] = {"log_level": self.log_level}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            cp.write(f)

    @classmethod
    def load(cls, path: str = DEFAULT_PATH) -> "AppSettings":
        s = cls()
        if not os.path.exists(path):
            return s
        cp = configparser.ConfigParser()
        cp.read(path)
        if cp.has_section("station"):
            s.callsign = cp.get("station", "callsign", fallback=s.callsign)
            s.auto_accept = bool(int(cp.get("station", "auto_accept",
                                            fallback="1")))
            s.receive_dir = cp.get("station", "receive_dir",
                                   fallback=s.receive_dir)
        if cp.has_section("audio"):
            s.audio_input_device = cp.get("audio", "input_device", fallback="")
            s.audio_output_device = cp.get("audio", "output_device", fallback="")
        if cp.has_section("expert"):
            s.forced_waveform = int(cp.get("expert", "forced_waveform",
                                           fallback="0xFF"), 0)
            s.forced_modulation = int(cp.get("expert", "forced_modulation",
                                             fallback="0xFF"), 0)
            s.forced_code_rate = int(cp.get("expert", "forced_code_rate",
                                            fallback="0xFF"), 0)
        if cp.has_section("debug"):
            s.log_level = cp.get("debug", "log_level", fallback=s.log_level)
        return s
