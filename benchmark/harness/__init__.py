"""The benchmark's yardstick: the cell spec, the measured window, the
trace reduction, the device record and the check's comparisons."""
