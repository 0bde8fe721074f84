"""One module a traffic kind: ``FAULTS = {name: fn(monkeypatch)}``, the
faults a cell of that kind can have, each planted underneath the timed path
by ``fn``. Found by kind under the registry's roots (``faults/<kind>.py``),
as its driver is; a twin's run with each planted has to read not correct."""
