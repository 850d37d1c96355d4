"""R005 fixture (port form): EventLog internals mutated outside
core/events.py."""


def rewind(log, ev):
    log._events.insert(0, ev)               # past the owning append path
    log._events[-1] = ev                    # rewrites history in place
    object.__setattr__(ev, "time", 0.0)     # re-times a frozen event
