"""Launchers of the port: ``serve`` is the OpenAI-compatible HTTP front end
over an engine pool."""
