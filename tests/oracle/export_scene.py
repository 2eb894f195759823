"""Scene → text export for the C++ oracle (native/oracle.cpp reads this).

Thin shim: the format now lives in the framework proper
(raytracer/io/scenefile.py — save_scene/load_scene round-trip); this
module keeps the historical oracle-side entry point.
"""

from raytracer.io.scenefile import save_scene as export_scene  # noqa: F401
