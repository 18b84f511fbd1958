"""Live evaluation dashboard (a copy of `pbhc_tpu/eval/dashboard.py`, stdlib
only; reference humanoidverse/agents/callbacks/
analysis_plot_motion_tracking.py — Flask + Plotly).

It needs neither flask nor plotly: a stdlib `http.server` thread serves a
self-contained HTML page that polls `/data` and draws line charts with
vanilla canvas JS. The eval loop pushes per-step channels (dof pos/vel,
torques, tracking errors, per-term rewards) through
`DashboardLogger.log_step`.

Usage:
    dash = DashboardLogger(port=8800)
    url = dash.start()     # serve from a daemon thread
    ... dash.log_step({"rew/teleop_joint_position": 0.9, "err/joint": 0.05, ...})
    dash.stop()
"""
from __future__ import annotations

import json
import threading
from collections import defaultdict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!doctype html><html><head><title>pbhc_tpu eval</title>
<style>body{font-family:monospace;background:#111;color:#eee}
.chart{display:inline-block;margin:8px;background:#1b1b1b;padding:6px;border-radius:6px}
canvas{background:#222}</style></head><body>
<h3>pbhc_tpu live evaluation</h3><div id="charts"></div>
<script>
const charts = {};
function ensure(name){
  if(charts[name]) return charts[name];
  const div=document.createElement('div');div.className='chart';
  div.innerHTML=`<div>${name}</div>`;
  const c=document.createElement('canvas');c.width=380;c.height=140;div.appendChild(c);
  document.getElementById('charts').appendChild(div);
  charts[name]={ctx:c.getContext('2d'),w:c.width,h:c.height};
  return charts[name];
}
function draw(name,data){
  const ch=ensure(name),g=ch.ctx;g.clearRect(0,0,ch.w,ch.h);
  if(data.length<2)return;
  const mn=Math.min(...data),mx=Math.max(...data),rng=(mx-mn)||1;
  g.strokeStyle='#6cf';g.beginPath();
  data.forEach((v,i)=>{const x=i/(data.length-1)*ch.w,y=ch.h-8-(v-mn)/rng*(ch.h-16);
    i?g.lineTo(x,y):g.moveTo(x,y);});
  g.stroke();g.fillStyle='#999';g.font='10px monospace';
  g.fillText(mx.toFixed(3),2,10);g.fillText(mn.toFixed(3),2,ch.h-2);
  g.fillText(data[data.length-1].toFixed(4),ch.w-60,12);
}
async function tick(){
  try{const r=await fetch('/data');const d=await r.json();
    for(const[k,v]of Object.entries(d))draw(k,v);}catch(e){}
  setTimeout(tick,500);
}
tick();
</script></body></html>"""


class DashboardLogger:
    def __init__(self, port=8800, history=2000):
        self.channels = defaultdict(lambda: deque(maxlen=history))
        self.port = port
        self._server = None

    def log_step(self, scalars: dict):
        for k, v in scalars.items():
            self.channels[k].append(float(v))

    def snapshot(self):
        return {k: list(v) for k, v in self.channels.items()}

    def _make_handler(self):
        logger = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/data":
                    body = json.dumps(logger.snapshot()).encode()
                    ctype = "application/json"
                else:
                    body = _PAGE.encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Handler

    def start(self):
        """Serve in a daemon thread (reference WebLogger:315, server :356-363)."""
        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), self._make_handler())
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return f"http://localhost:{self.port}"

    def stop(self):
        if self._server:
            self._server.shutdown()
