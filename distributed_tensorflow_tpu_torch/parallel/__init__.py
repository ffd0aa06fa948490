"""Execution strategies of the port: ``SingleDevice`` (the reference's
``tfsingle.py`` mode). The data-parallel strategies are ROADMAP A6."""
