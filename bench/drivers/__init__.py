"""One driver a traffic kind (``traffic/<mix>.json``'s ``kind``):
``drivers/<kind>.py`` defines ``Driver(setup, fault=None)`` with
``unit``, ``launches`` (the program's launches a unit), ``trace(sync)``,
``window(seconds)``, ``answers()`` and ``close()``."""
