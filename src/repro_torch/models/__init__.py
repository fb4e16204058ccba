"""Dense decoder LM of the serving path (``layers``, ``transformer``)."""
