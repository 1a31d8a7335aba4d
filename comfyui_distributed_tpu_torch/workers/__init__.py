"""Worker processes of a master: launch, watchdog, stop, persistence, and
host detection. A managed worker is a controller serving the control
plane on its own port, on the master's device."""
