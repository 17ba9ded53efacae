"""Pipelines of the port (the counterpart of ``txr.pipelines``)."""
