"""Serving layer: REST API, dashboard and metrics exporter.

The HTTP surface is a small standard-library WSGI framework
(``serving/wsgi.py``) with the JAX package's route map and JSON schemas
(``serving/app.py``); real-time push is a WebSocket at /ws and Server-Sent
Events at /events.
"""
