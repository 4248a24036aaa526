"""Loop drivers, one module per ``loop`` kind a mix file names: ``offline`` (a
closed loop of ``AudioCodec.encode`` then ``decode``) and ``http_open_loop``
(the real server under open-loop arrivals).  Each has ``run(run: cell.Run)``,
which fills the run's end-to-end metrics, set-up time, counts, correctness
numbers and trace summary."""
