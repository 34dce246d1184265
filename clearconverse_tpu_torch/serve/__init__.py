"""Serving layer of the port: the reference's HTTP/WS surface
(back/api.py:1555-2785) on a first-party asyncio HTTP/1.1 + WebSocket
micro-framework, in front of the port's TranscriptionEngine on the card.

  http.py      HTTP server, router, multipart/form parsing, RFC 6455
               WebSocket (a copy of the JAX package's)
  app.py       the 16 routes + CORS + background cleanup; ``main()`` refuses
               to start without a CUDA device outside dev mode
  tasks.py     the marker-file task protocol (progress.json,
               completed/error/cancelled/in_progress.txt) with an in-process
               executor against one loaded engine
  factory.py   the engine the app and the warm-up build
  warmup.py    drives the engine and every decode row bucket once before
               traffic (kernel builds, cuBLAS/cuDNN set-up)
  pdf.py       the transcript PDF writer (a copy of the JAX package's)
  urls.py      URL validation and download incl. Google Drive's confirm
               token

Start it with ``python -m clearconverse_tpu_torch.serve``
(``CC_TPU_FAKE_MODELS=1`` for the weight-free dev backend on the CPU).
"""
