"""Entry points of the port (``serve``, ``train``) and the device meshes
they run over (``mesh``)."""
