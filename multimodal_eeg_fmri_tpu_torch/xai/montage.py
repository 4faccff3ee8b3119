"""EEG montage tables: 10-20 channel names, 2D positions, region groups.
Counterpart of ``multimodal_eeg_fmri_tpu/xai/montage.py``, copied: the port
imports nothing of the JAX package.

Standard international 10-20 electrode nomenclature and scalp geometry
(public domain clinical convention; the reference keeps equivalent tables at
``eeg_xai_analysis.py:28-81``). The 18-channel set is the reference
recording montage (ERP = 18 channels, SURVEY §0); 19/21/32-channel layouts
are provided for other caps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# 10-20 system, 19 scalp electrodes (old nomenclature T3/T4/T5/T6)
CHANNEL_NAMES_19: List[str] = [
    "Fp1", "Fp2", "F7", "F3", "Fz", "F4", "F8",
    "T3", "C3", "Cz", "C4", "T4",
    "T5", "P3", "Pz", "P4", "T6",
    "O1", "O2",
]

# the reference's 18-channel recording montage: 10-20 without Cz reference
CHANNEL_NAMES_18: List[str] = [c for c in CHANNEL_NAMES_19 if c != "Cz"]

CHANNEL_NAMES_21: List[str] = CHANNEL_NAMES_19 + ["A1", "A2"]

CHANNEL_NAMES_32: List[str] = [
    "Fp1", "Fp2", "F7", "F3", "Fz", "F4", "F8",
    "FC5", "FC1", "FC2", "FC6",
    "T7", "C3", "Cz", "C4", "T8",
    "CP5", "CP1", "CP2", "CP6",
    "P7", "P3", "Pz", "P4", "P8",
    "PO3", "PO4", "O1", "Oz", "O2",
    "AF3", "AF4",
]

# normalized (x, y) scalp positions, nose up, 0-1 square
CHANNEL_POSITIONS: Dict[str, Tuple[float, float]] = {
    "Fp1": (0.35, 0.95), "Fpz": (0.50, 0.95), "Fp2": (0.65, 0.95),
    "AF3": (0.38, 0.88), "AFz": (0.50, 0.88), "AF4": (0.62, 0.88),
    "F7": (0.15, 0.75), "F3": (0.35, 0.75), "Fz": (0.50, 0.75),
    "F4": (0.65, 0.75), "F8": (0.85, 0.75),
    "FC5": (0.22, 0.65), "FC1": (0.40, 0.65),
    "FC2": (0.60, 0.65), "FC6": (0.78, 0.65),
    "T3": (0.08, 0.50), "T7": (0.08, 0.50),
    "C3": (0.30, 0.50), "Cz": (0.50, 0.50), "C4": (0.70, 0.50),
    "T4": (0.92, 0.50), "T8": (0.92, 0.50),
    "CP5": (0.22, 0.35), "CP1": (0.40, 0.35),
    "CP2": (0.60, 0.35), "CP6": (0.78, 0.35),
    "T5": (0.15, 0.25), "P7": (0.15, 0.25),
    "P3": (0.35, 0.25), "Pz": (0.50, 0.25), "P4": (0.65, 0.25),
    "T6": (0.85, 0.25), "P8": (0.85, 0.25),
    "PO3": (0.38, 0.15), "POz": (0.50, 0.15), "PO4": (0.62, 0.15),
    "O1": (0.35, 0.05), "Oz": (0.50, 0.05), "O2": (0.65, 0.05),
    "A1": (0.02, 0.50), "A2": (0.98, 0.50),
    "M1": (0.02, 0.50), "M2": (0.98, 0.50),
}

REGION_GROUPS: Dict[str, List[str]] = {
    "Frontal": ["Fp1", "Fp2", "Fpz", "F7", "F3", "Fz", "F4", "F8",
                "AF3", "AF4"],
    "Central": ["C3", "Cz", "C4", "FC1", "FC2", "FC5", "FC6"],
    "Temporal": ["T3", "T4", "T5", "T6", "T7", "T8", "P7", "P8"],
    "Parietal": ["P3", "Pz", "P4", "CP1", "CP2", "CP5", "CP6"],
    "Occipital": ["O1", "Oz", "O2", "PO3", "PO4"],
}


def default_channel_names(n_channels: int) -> List[str]:
    """Pick the conventional layout for a channel count (reference
    ``ChannelImportanceExtractor.__init__`` behavior)."""
    table = {18: CHANNEL_NAMES_18, 19: CHANNEL_NAMES_19,
             21: CHANNEL_NAMES_21, 32: CHANNEL_NAMES_32}
    if n_channels in table:
        return list(table[n_channels])
    return [f"Ch{i + 1}" for i in range(n_channels)]


def channel_region(name: str) -> Optional[str]:
    for region, chans in REGION_GROUPS.items():
        if name in chans:
            return region
    return None


def pair_names(channel_names: List[str]) -> List[Tuple[str, str]]:
    """Upper-triangle channel-pair names in the CONN feature order
    (3 metrics × C(n,2); pairs repeat per metric)."""
    n = len(channel_names)
    return [(channel_names[i], channel_names[j])
            for i in range(n) for j in range(i + 1, n)]
