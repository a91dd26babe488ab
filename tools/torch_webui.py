#!/usr/bin/env python3
"""Browser front-end on the PyTorch/CUDA port: the reference GUI's panels
served over HTTP (``tools/webui.py`` serves the same page from the JAX
package; reference src/gui/app.cpp: live waterfall, constellation, status
bar, message console, connect/send/file/settings controls, and the
``-sim`` virtual remote station).

The page is the JAX tool's, from a stdlib ``http.server`` (JS polls
/api/state and paints two canvases).  The backend is ``tools/torch_tui.py
--sim``'s pair on the run's device: a local station (W1AW) and a virtual
remote (VE3ABC), each transmission handed to the other through
``channel`` (2,000 samples of lead, 4,000 of tail, ``add_noise_active`` at
``--snr`` from a ``torch.Generator`` seeded from the transmission's
length).  Controls POST to /api/connect, /api/ping, /api/send,
/api/sendfile, /api/settings and /api/disconnect; the remote answers
every chat message, so traffic flows both ways.

The HTTP handlers run on ``ThreadingHTTPServer`` worker threads and call
the engines from there: ``ModemEngine`` is single-threaded unless its
caller locks, so every call into either station, and every read of
their state, holds ``Station.lock``.  (The JAX tool marshals its calls
to the main thread, a workaround for its TPU transport's readbacks; CUDA
calls from worker threads need none.)

``--script`` drives a scripted session through the HTTP API (connect with
waterfall rows; chat echo with constellation points and mode history; a
3,000-byte file transfer with progress; disconnect; forced QPSK R1/4;
forced waveform OFDM_COX), prints PASS and one JSON object (result, the
port served, wall seconds, each kernel's launches) and exits 0; a failed
step raises.  ``--port 0`` binds a free port.  Runs on the card unless
``--cpu``.

    python3 tools/torch_webui.py [--cpu] [--snr 15] [--port 8752]   # serve
    python3 tools/torch_webui.py --script --port 0 [--cpu]
"""

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

PAGE = """<!DOCTYPE html>
<html><head><title>ultra-tpu</title><style>
body{background:#101418;color:#cdd6dd;font-family:monospace;margin:14px}
h1{font-size:16px;color:#7fd4a0} .row{display:flex;gap:16px;flex-wrap:wrap}
canvas{background:#000;border:1px solid #2a3740;image-rendering:pixelated}
#status{white-space:pre;background:#161d23;padding:8px;border:1px solid #2a3740}
#console{white-space:pre-wrap;background:#161d23;height:140px;overflow-y:auto;
 padding:8px;border:1px solid #2a3740;width:640px}
button{background:#22303a;color:#cdd6dd;border:1px solid #3a4a56;padding:4px 10px;
 cursor:pointer} input{background:#0c1114;color:#cdd6dd;border:1px solid #3a4a56;
 padding:4px;width:320px}
</style></head><body>
<h1>ultra-tpu &mdash; HF modem console (virtual remote: VE3ABC)</h1>
<div class=row>
 <div><div>waterfall 0-3 kHz</div>
  <canvas id=wf width=256 height=200></canvas></div>
 <div><div>constellation</div>
  <canvas id=ct width=120 height=120></canvas></div>
 <div><div>mode / adaptive (last frames)</div>
  <div id=modes style="white-space:pre;background:#161d23;padding:8px;
   border:1px solid #2a3740;height:184px;overflow-y:auto;width:240px"></div></div>
 <div id=status>connecting to backend...</div>
</div>
<p>
 <button onclick="act('connect')">Connect</button>
 <button onclick="act('ping')">Ping</button>
 <button onclick="act('disconnect')">Disconnect</button>
 <input id=msg placeholder="message text" onkeydown="if(event.key=='Enter')send()">
 <button onclick="send()">Send</button>
</p>
<div id=console></div>
<fieldset style="border:1px solid #2a3740;margin-top:12px;width:640px">
 <legend>file transfer</legend>
 <input id=fpath placeholder="local file path to send" style="width:420px">
 <button onclick="sendfile()">Send file</button>
 <div id=fprog style="white-space:pre;padding:4px"></div>
</fieldset>
<fieldset style="border:1px solid #2a3740;margin-top:12px;width:640px">
 <legend>settings / expert mode (0xFF = AUTO; persisted to INI)</legend>
 callsign <input id=s_call style="width:90px">
 forced waveform <select id=s_wf></select>
 forced modulation <select id=s_mod></select>
 forced rate <select id=s_rate></select>
 <button onclick="saveSettings()">Save</button>
 <span id=s_msg></span>
</fieldset>
<script>
const MODS=['AUTO','BPSK','QPSK','QAM16','QAM64','DBPSK','DQPSK','D8PSK',
            'QAM32','QAM256'];
const RATES=['AUTO','R1_4','R1_2','R2_3','R3_4','R5_6'];
// No 'DPSK': WaveformMode.DPSK (0x06) is an engine-local extension with no
// ModeCapabilities bit — negotiate_mode silently ignores it, so offering it
// would behave as AUTO with no feedback (reference GUI: AUTO/OFDM/MC_DPSK).
const WFS=['AUTO','OFDM_COX','MC_DPSK','OFDM_CHIRP'];
for(const [id,vals] of [['s_mod',MODS],['s_rate',RATES],['s_wf',WFS]]){
 const el=document.getElementById(id);
 for(const v of vals){const o=document.createElement('option');
  o.textContent=v;el.appendChild(o);}}
async function act(a){await fetch('/api/'+a,{method:'POST'});}
async function send(){const m=document.getElementById('msg');
 if(!m.value)return; await fetch('/api/send',{method:'POST',body:m.value});
 m.value='';}
async function sendfile(){const p=document.getElementById('fpath');
 if(!p.value)return;
 await fetch('/api/sendfile',{method:'POST',body:p.value});}
async function loadSettings(){
 const s=await (await fetch('/api/settings')).json();
 document.getElementById('s_call').value=s.callsign;
 document.getElementById('s_wf').value=s.forced_waveform;
 document.getElementById('s_mod').value=s.forced_modulation;
 document.getElementById('s_rate').value=s.forced_code_rate;}
async function saveSettings(){
 const body=JSON.stringify({
  callsign:document.getElementById('s_call').value,
  forced_waveform:document.getElementById('s_wf').value,
  forced_modulation:document.getElementById('s_mod').value,
  forced_code_rate:document.getElementById('s_rate').value});
 await fetch('/api/settings',{method:'POST',body});
 document.getElementById('s_msg').textContent='saved';
 setTimeout(()=>document.getElementById('s_msg').textContent='',1500);}
loadSettings();
async function tick(){
 try{
  const s=await (await fetch('/api/state')).json();
  document.getElementById('status').textContent=s.status;
  const wf=document.getElementById('wf'),g=wf.getContext('2d');
  if(s.waterfall.length){
   const rows=s.waterfall,W=rows[0].length,H=rows.length;
   const img=g.createImageData(W,H);
   for(let y=0;y<H;y++)for(let x=0;x<W;x++){
    const v=rows[y][x],i=4*(y*W+x);
    img.data[i]=v*0.2; img.data[i+1]=v; img.data[i+2]=v*0.55; img.data[i+3]=255;}
   wf.width=W; wf.height=H; g.putImageData(img,0,0);}
  const ct=document.getElementById('ct'),c=ct.getContext('2d');
  c.fillStyle='#000'; c.fillRect(0,0,120,120);
  c.strokeStyle='#2a3740'; c.beginPath(); c.moveTo(60,0); c.lineTo(60,120);
  c.moveTo(0,60); c.lineTo(120,60); c.stroke(); c.fillStyle='#7fd4a0';
  for(const p of s.constellation)
   c.fillRect(60+p[0]*54-1,60-p[1]*54-1,2,2);
  document.getElementById('modes').textContent=
   s.modes.map(m=>`${m[0].padEnd(12)} ${m[1].toFixed(1)} dB  fade ${m[2]}  ${m[3]||''}`)
          .reverse().join('\n');
  const con=document.getElementById('console');
  con.textContent=s.console.join('\\n');
  con.scrollTop=con.scrollHeight;
  const t=s.transfer;
  document.getElementById('fprog').textContent = t.filename ?
   `${t.direction} ${t.filename}: ${t.done}/${t.total} bytes `+
   `(${t.pct.toFixed(0)}%) ${t.complete?'COMPLETE':''}` : '';
 }catch(e){}
 setTimeout(tick,500);}
tick();
</script></body></html>"""

LEAD, TAIL = 2000, 4000


def channel(audio, snr_db, device):
    """The air between the stations: ``audio`` (numpy) with its lead and
    tail, through ``add_noise_active`` on ``device``; returns numpy."""
    import numpy as np
    import torch
    from projectultra_tpu_torch.sim import watterson as W
    x = torch.from_numpy(np.concatenate(
        [np.zeros(LEAD, np.float32), audio,
         np.zeros(TAIL, np.float32)])[None, :]).to(device)
    g = W.seeded_generator(device, len(audio) & 0xFFFF)
    return W.add_noise_active(x, snr_db, g)[0].cpu().numpy()


class Station:
    """The ``--sim`` backend: local + virtual remote over a noisy channel,
    on ``device``.  Every action holds ``lock`` around its engine calls."""

    WF_HISTORY = 200  # scrollback depth (reference waterfall widget scale)

    def __init__(self, snr_db: float, device, settings_path=None):
        import tempfile
        from projectultra_tpu_torch.protocol.engine import ProtocolEngine
        from projectultra_tpu_torch.utils.settings import AppSettings

        self.lock = threading.Lock()
        self.device = device
        self.console = []
        self.last_rx = None
        self.snr_db = snr_db
        # Rolling waterfall history (the reference waterfall widget keeps a
        # ~200-line scrollback): rows from every rx audio block, newest last.
        self.wf_hist = []
        # Mode/adaptive history for the panel: (mode, snr, fade) per frame.
        self.mode_hist = []
        # Settings layer (settings.cpp): INI persistence + expert forced
        # mod/rate applied to the connection.
        self.settings_path = settings_path or os.path.join(
            tempfile.mkdtemp(prefix="ultra_webui_"), "settings.ini")
        self.settings = AppSettings.load(self.settings_path)
        self.transfer = {"filename": "", "direction": "", "done": 0,
                         "total": 0, "pct": 0.0, "complete": False}
        a = ProtocolEngine(device=device)
        b = ProtocolEngine(device=device)
        a.connection.set_local_callsign(self.settings.callsign
                                        if self.settings.callsign != "N0CALL"
                                        else "W1AW")
        b.connection.set_local_callsign("VE3ABC")
        b.connection.set_measured_snr(snr_db)
        a.modem.collect_constellation = True
        b.modem.collect_constellation = True
        self._apply_expert(a)

        # File-transfer wiring: live progress (file_transfer.hpp:47
        # callbacks) on the sender, delivery at the virtual remote.
        self.rx_dir = tempfile.mkdtemp(prefix="ultra_webui_rx_")
        b.connection.file_transfer.receive_dir = self.rx_dir

        def _prog(p, direction="tx"):
            self.transfer = {"filename": p.filename, "direction": direction,
                             "done": p.transferred_bytes,
                             "total": p.total_bytes,
                             "pct": p.percentage,
                             "complete": p.transferred_bytes >= p.total_bytes
                             and p.total_bytes > 0}
        a.connection.file_transfer.on_progress = _prog
        b.connection.file_transfer.on_progress = \
            lambda p: _prog(p, direction="rx")
        b.connection.file_transfer.on_received = \
            lambda path, ok: self.console.append(
                f"* file received at VE3ABC: {os.path.basename(path)} "
                f"({'ok' if ok else 'CORRUPT'})")

        def a_to_b(audio):
            b.feed_audio(channel(audio, snr_db, device))

        def b_to_a(audio):
            rx = channel(audio, snr_db, device)
            self.last_rx = rx
            self._wf_accumulate(rx)
            a.feed_audio(rx)

        a.on_tx_audio = a_to_b
        b.on_tx_audio = b_to_a

        _user_on_frame = a.modem.on_frame

        def _frame_hook(fr):
            m = a.modem
            self.mode_hist.append(
                (f"{m.data_modulation.name}/"
                 f"{m.data_code_rate.name[1:].replace('_', '/')}",
                 round(fr.wideband_snr_db, 1), round(fr.fade_spread_db, 1),
                 fr.waveform.name))
            del self.mode_hist[:-40]
            if _user_on_frame:
                _user_on_frame(fr)
        # ProtocolEngine wired on_frame in its constructor: wrap, don't
        # replace.
        a.modem.on_frame = _frame_hook
        a.connection.on_message_received = \
            lambda t: self.console.append(f"VE3ABC> {t}")
        # Virtual remote auto-reply (GUI -sim behavior).
        b.connection.on_message_received = \
            lambda t: b.send_message(f"rx ok: {t}")
        self.a, self.b = a, b

    def _wf_accumulate(self, rx):
        """Append this rx block's STFT rows (on the station's device) to the
        rolling history (dB, un-normalized: normalization happens over the
        window at render time so old rows don't pump as new audio
        arrives)."""
        import numpy as np
        import torch
        from projectultra_tpu_torch.utils.observability import waterfall
        if len(rx) < 4096:
            return
        db, freqs = waterfall(torch.from_numpy(rx).to(self.device))
        keep = freqs <= 3000.0
        rows = db[:, keep]
        cols = np.linspace(0, rows.shape[1] - 1, 256).astype(int)
        self.wf_hist.extend(rows[:, cols])
        del self.wf_hist[:-self.WF_HISTORY]

    # --- actions (serialized by the lock; each pumps the full exchange)
    def connect(self):
        with self.lock:
            self.a.connect("VE3ABC")
            self.console.append(
                "* connected" if self.a.connection.is_connected
                else "* connect failed")

    def ping(self):
        with self.lock:
            self.a._tx_ping()  # chirp PING over the air
            self.console.append("* ping sent")

    def send(self, text: str):
        with self.lock:
            ok = self.a.send_message(text)
            self.console.append(f"me> {text}" if ok else "* send failed")
            for _ in range(20):
                self.a.tick(1000)
                self.b.tick(1000)

    def disconnect(self):
        with self.lock:
            self.a.disconnect()
            self.console.append("* disconnected")

    def _apply_expert(self, engine):
        """Expert forced waveform/mod/rate (AUTO = 0xFF) -> connection
        config, the layer the reference's settings widget drives
        (settings.cpp).  The forced waveform is the preferred negotiated
        mode carried in the CONNECT frame (app.cpp:408 setPreferredMode;
        frame_v2.cpp:635 "0xFF = AUTO, else forced"); the handshake itself
        still rides the connect waveform."""
        from projectultra_tpu_torch.config import CodeRate, Modulation
        from projectultra_tpu_torch.protocol.frame_v2 import WaveformMode
        from projectultra_tpu_torch.utils.settings import AUTO
        s = self.settings
        engine.connection.config.forced_modulation = \
            Modulation.AUTO if s.forced_modulation == AUTO \
            else Modulation(s.forced_modulation)
        engine.connection.config.forced_code_rate = \
            CodeRate.AUTO if s.forced_code_rate == AUTO \
            else CodeRate(s.forced_code_rate)
        engine.connection.config.preferred_mode = \
            WaveformMode.AUTO if s.forced_waveform == AUTO \
            else WaveformMode(s.forced_waveform)

    def get_settings(self) -> dict:
        from projectultra_tpu_torch.config import CodeRate, Modulation
        from projectultra_tpu_torch.protocol.frame_v2 import WaveformMode
        from projectultra_tpu_torch.utils.settings import AUTO
        with self.lock:
            s = self.settings
            return {
                "callsign": s.callsign,
                "auto_accept": s.auto_accept,
                "receive_dir": s.receive_dir,
                "forced_waveform": ("AUTO" if s.forced_waveform == AUTO
                                    else WaveformMode(s.forced_waveform).name),
                "forced_modulation": ("AUTO" if s.forced_modulation == AUTO
                                      else Modulation(s.forced_modulation).name),
                "forced_code_rate": ("AUTO" if s.forced_code_rate == AUTO
                                     else CodeRate(s.forced_code_rate).name),
                "path": self.settings_path,
            }

    def set_settings(self, body: str):
        """POST /api/settings: update + persist to INI + apply live."""
        from projectultra_tpu_torch.config import CodeRate, Modulation
        from projectultra_tpu_torch.protocol.frame_v2 import WaveformMode
        from projectultra_tpu_torch.utils.settings import AUTO
        d = json.loads(body)
        with self.lock:
            s = self.settings
            if "callsign" in d and d["callsign"]:
                s.callsign = d["callsign"]
                self.a.connection.set_local_callsign(s.callsign)
            if "auto_accept" in d:
                s.auto_accept = bool(d["auto_accept"])
            if "receive_dir" in d and d["receive_dir"]:
                s.receive_dir = d["receive_dir"]
            if "forced_waveform" in d:
                v = d["forced_waveform"]
                s.forced_waveform = AUTO if v == "AUTO" \
                    else int(WaveformMode[v])
            if "forced_modulation" in d:
                v = d["forced_modulation"]
                s.forced_modulation = AUTO if v == "AUTO" \
                    else int(Modulation[v])
            if "forced_code_rate" in d:
                v = d["forced_code_rate"]
                s.forced_code_rate = AUTO if v == "AUTO" else int(CodeRate[v])
            s.save(self.settings_path)
            self._apply_expert(self.a)
            self.console.append("* settings saved "
                                f"(mod={d.get('forced_modulation', '-')} "
                                f"rate={d.get('forced_code_rate', '-')})")

    def send_file(self, path: str):
        """Start a file transfer + pump the exchange to completion; live
        progress flows through the on_progress callback into state()."""
        with self.lock:
            if not os.path.exists(path):
                self.console.append(f"* no such file: {path}")
                return
            if not self.a.connection.send_file(path):
                self.console.append("* file send refused (not connected?)")
                return
            self.console.append(f"me> [file] {os.path.basename(path)}")
            for _ in range(400):
                self.a.tick(5000)
                self.b.tick(5000)
                if self.transfer.get("complete") and \
                        self.a.connection.file_transfer.state.name \
                        != "SENDING":
                    break

    def state(self) -> dict:
        import numpy as np
        from projectultra_tpu_torch.utils.observability import constellation
        with self.lock:
            c = self.a.connection
            m = self.a.modem
            status = (
                f"state:    {c.state.name}\n"
                f"remote:   {c.remote_call or '-'}\n"
                f"waveform: "
                f"{c.negotiated_mode.name if c.is_connected else '-'}\n"
                f"mode:     {m.data_modulation.name} "
                f"{m.data_code_rate.name[1:].replace('_', '/')}\n"
                f"snr:      {m.stats.current_snr_db:5.1f} dB "
                f"(wideband {m.stats.wideband_snr_db:5.1f})\n"
                f"frames:   tx {m.stats.frames_sent} / "
                f"rx {m.stats.frames_received}\n"
                f"rescued:  crc {m.stats.frames_crc_recovered} / "
                f"front {m.stats.frames_front_retried}\n"
                f"pings rx: {m.pings_received}")
            wf_rows = []
            if self.wf_hist:
                db = np.stack(self.wf_hist)          # [<=200, 256] dB
                lo, hi = float(db.min()), float(max(db.max(),
                                                    db.min() + 1e-6))
                norm = ((db - lo) / (hi - lo) * 255).astype(np.uint8)
                wf_rows = norm.tolist()
            pts = []
            if m.last_constellation is not None and \
                    len(m.last_constellation):
                iq = constellation(m.last_constellation)
                lim = max(1e-6, float(np.abs(iq).max()))
                pts = [[float(p[0]) / lim, float(p[1]) / lim]
                       for p in iq[:400]]
            return {"status": status, "waterfall": wf_rows,
                    "constellation": pts, "console": self.console[-50:],
                    "transfer": dict(self.transfer),
                    "modes": [list(m) for m in self.mode_hist]}


def make_server(station: Station, port: int):
    """A ThreadingHTTPServer on 127.0.0.1:``port`` (0: a free port; the
    bound one is ``server_address[1]``) serving the page and the API."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, code, body, ctype="application/json"):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/":
                self._reply(200, PAGE, "text/html")
            elif self.path == "/api/state":
                self._reply(200, json.dumps(station.state()))
            elif self.path == "/api/settings":
                self._reply(200, json.dumps(station.get_settings()))
            else:
                self._reply(404, "{}")

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n).decode() if n else ""
            if self.path == "/api/connect":
                station.connect()
            elif self.path == "/api/ping":
                station.ping()
            elif self.path == "/api/send":
                station.send(body)
            elif self.path == "/api/sendfile":
                station.send_file(body)
            elif self.path == "/api/settings":
                station.set_settings(body)
            elif self.path == "/api/disconnect":
                station.disconnect()
            else:
                return self._reply(404, "{}")
            self._reply(200, "{}")

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def run_script(port: int) -> int:
    """Scripted end-to-end session through the HTTP API on ``port``; a
    failed step raises."""
    import urllib.request

    def post(path, data=b""):
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", data=data, timeout=600).read()

    def get(path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=600) as r:
            return json.loads(r.read())

    def require(cond, what):
        if not cond:
            raise RuntimeError(f"webui scripted session: {what}")

    s0 = get("/api/state")
    require("DISCONNECTED" in s0["status"], s0["status"])
    post("/api/connect")
    s1 = get("/api/state")
    require("CONNECTED" in s1["status"], s1["status"])
    require(len(s1["waterfall"]) > 0, "no waterfall rows after connect")
    post("/api/send", b"hello from browser")
    s2 = get("/api/state")
    require(any("rx ok: hello from browser" in ln for ln in s2["console"]),
            s2["console"])
    require(len(s2["constellation"]) > 0, "no constellation points")
    require(len(s2["modes"]) > 0, "no mode/adaptive history rows")

    # File transfer end-to-end through the HTTP API with progress events.
    import tempfile
    import numpy as np
    src = os.path.join(tempfile.mkdtemp(prefix="ultra_webui_tx_"),
                       "brochure.bin")
    with open(src, "wb") as f:
        f.write(np.random.default_rng(11).integers(
            0, 256, 3000, dtype=np.uint8).tobytes())
    post("/api/sendfile", src.encode())
    s2f = get("/api/state")
    t = s2f["transfer"]
    require(t["filename"] == "brochure.bin", t)
    require(t["complete"] and t["done"] >= t["total"] > 0, t)
    require(any("file received at VE3ABC: brochure.bin (ok)" in ln
                for ln in s2f["console"]), s2f["console"])
    post("/api/disconnect")
    s3 = get("/api/state")
    require("DISCONNECTED" in s3["status"], s3["status"])

    # Expert forced mode: QPSK + R1/4 must observably change the
    # negotiated data mode on the next connect (settings.cpp semantics).
    post("/api/settings", json.dumps(
        {"forced_modulation": "QPSK", "forced_code_rate": "R1_4"}).encode())
    st = get("/api/settings")
    require(st["forced_modulation"] == "QPSK", st)
    post("/api/connect")
    s4 = get("/api/state")
    require("CONNECTED" in s4["status"], s4["status"])
    require("mode:     QPSK 1/4" in s4["status"], s4["status"])
    post("/api/disconnect")
    post("/api/settings", json.dumps(
        {"forced_modulation": "AUTO", "forced_code_rate": "AUTO"}).encode())

    # Expert forced waveform = the preferred negotiated mode carried in
    # the CONNECT frame (app.cpp:408 setPreferredMode): forcing OFDM_COX
    # must observably negotiate the session onto OFDM_COX.
    post("/api/settings", json.dumps({"forced_waveform": "OFDM_COX"}).encode())
    st = get("/api/settings")
    require(st["forced_waveform"] == "OFDM_COX", st)
    post("/api/connect")
    s5 = get("/api/state")
    require("CONNECTED" in s5["status"], s5["status"])
    require("waveform: OFDM_COX" in s5["status"], s5["status"])
    post("/api/disconnect")
    post("/api/settings", json.dumps({"forced_waveform": "AUTO"}).encode())
    print("webui scripted session: PASS (chat + file + expert mode + waveform)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--snr", type=float, default=15.0)
    ap.add_argument("--port", type=int, default=8752,
                    help="port to serve on (0: a free one)")
    ap.add_argument("--script", action="store_true",
                    help="drive a scripted session through the HTTP API")
    args = ap.parse_args(argv)

    from projectultra_tpu_torch.device import card_line, resolve
    from projectultra_tpu_torch.ops import cuda_ldpc, cuda_sc

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    launches0 = (cuda_ldpc.launches, cuda_sc.launches)
    t0 = time.perf_counter()
    station = Station(args.snr, device)
    srv = make_server(station, args.port)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        if args.script:
            rc = run_script(port)
        else:
            print(f"ultra-tpu web console: http://127.0.0.1:{port}/",
                  flush=True)
            rc = 0
            try:
                while t.is_alive():
                    t.join(timeout=0.5)
            except KeyboardInterrupt:
                pass
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=60)
    print(json.dumps({
        "result": "PASS" if rc == 0 else "FAIL", "port": port,
        "wall_seconds": time.perf_counter() - t0,
        "launches": {"ldpc_minsum": cuda_ldpc.launches - launches0[0],
                     "sc_windows": cuda_sc.launches - launches0[1]},
        "device": card}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
