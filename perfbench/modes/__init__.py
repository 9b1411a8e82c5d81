"""The windows' loops, one module per mode, found by the name a traffic
file gives."""
