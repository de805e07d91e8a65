"""The slasher plane: the min/max-target arrays and surround checks on the
card (`device.py`)."""
