"""Self-contained interactive signal dashboard (single HTML file).

Parity target: the reference's plotly dashboards in
``tools/sample.py:51-258`` — interactive waveform, spectrum, spectrogram
heatmap, a statistics table, and the rotatable 3-D time-frequency
surface — plus the correlation-debug trace the reference only exposes as
a CSV dump (``examples/ask.rs:346-350`` ``power_debug``).

The environment has no plotly and no network egress, so the output is a
*dependency-free* HTML file: data embedded as base64 ``Float32Array`` /
``Uint8Array`` blobs and a small hand-written canvas renderer providing
wheel-zoom, drag-pan, hover readouts, a synced x-axis across the
time-aligned panels, and a drag-rotate painter's-algorithm 3-D surface.
Open it with any browser — no server, no CDN.
"""

from __future__ import annotations

import base64
import html as html_mod
import json
import pathlib

import numpy as np

from trackmaker_tpu.bench.viz import _load, spectrogram

_MAX_WAVE = 1 << 20          # embedded waveform points (min/max envelope)
_MAX_SPEC = 1 << 15          # embedded spectrum points
_MAX_SGRAM_T = 2048          # spectrogram time bins
_MAX_SURF = 96               # 3-D surface grid edge


def _b64_f32(a: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(a, np.float32).tobytes()).decode()


def _b64_u8(a: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(a, np.uint8).tobytes()).decode()


def _envelope(x: np.ndarray, max_pts: int) -> tuple[np.ndarray, int]:
    """Min/max-envelope decimation: every output PAIR brackets one input
    bin, so peaks survive any decimation ratio.  Returns (samples,
    stride) where stride is input samples per output point."""
    t = len(x)
    if t <= max_pts:
        return x.astype(np.float32), 1
    nb = max_pts // 2
    k = -(-t // nb)
    pad = np.pad(x, (0, nb * k - t), constant_values=x[-1] if t else 0.0)
    b = pad.reshape(nb, k)
    out = np.empty(nb * 2, np.float32)
    out[0::2] = b.min(axis=1)
    out[1::2] = b.max(axis=1)
    return out, max(k // 2, 1)


def _spectrum_db(x: np.ndarray, sr: int) -> tuple[np.ndarray, float]:
    """(magnitude dB decimated by max-binning, Hz per output point)."""
    mag = np.abs(np.fft.rfft(x))
    db = 20.0 * np.log10(np.maximum(mag, 1e-9))
    hz_per = sr / 2.0 / max(len(db) - 1, 1)
    if len(db) > _MAX_SPEC:
        k = -(-len(db) // _MAX_SPEC)
        pad = np.pad(db, (0, _MAX_SPEC * k - len(db)),
                     constant_values=-180.0)
        db = pad.reshape(_MAX_SPEC, k).max(axis=1)
        hz_per *= k
    return db.astype(np.float32), hz_per


def _pool_max(a: np.ndarray, axis: int, target: int) -> np.ndarray:
    n = a.shape[axis]
    if n <= target:
        return a
    k = -(-n // target)
    nb = -(-n // k)
    pads = [(0, 0)] * a.ndim
    pads[axis] = (0, nb * k - n)
    a = np.pad(a, pads, constant_values=a.min())
    shp = list(a.shape)
    shp[axis:axis + 1] = [nb, k]
    return a.reshape(shp).max(axis=axis + 1)


def _stats_rows(x: np.ndarray) -> list[tuple[str, str]]:
    rms = float(np.sqrt(np.mean(x ** 2))) if len(x) else 0.0
    return [
        ("samples", f"{len(x)}"),
        ("max", f"{float(x.max()):.5f}" if len(x) else "0"),
        ("min", f"{float(x.min()):.5f}" if len(x) else "0"),
        ("mean", f"{float(x.mean()):.5f}" if len(x) else "0"),
        ("std", f"{float(x.std()):.5f}" if len(x) else "0"),
        ("RMS", f"{rms:.5f}"),
        ("crest factor",
         f"{float(np.abs(x).max()) / (rms + 1e-10):.3f}" if len(x) else "0"),
    ]


def correlation_debug(samples: np.ndarray, sr: int,
                      mode: str = "line", cfg=None) -> dict[str, np.ndarray]:
    """Decoder-debug traces for the dashboard: the dense preamble
    correlation (line-coded PHY) or the ASK sync/EMA-power pair
    (``power_debug`` in examples/ask.rs:346-350)."""
    import jax.numpy as jnp
    x = jnp.asarray(samples, jnp.float32)
    if mode == "ask":
        from trackmaker_tpu.phy import ask
        acfg = cfg or ask.AskConfig()
        power, sync, _ = ask.dense_arrays(acfg, x)
        return {"sync power": np.asarray(sync),
                "EMA power": np.asarray(power)}
    from trackmaker_tpu.core.config import PhyConfig
    from trackmaker_tpu.phy import line_coding
    from trackmaker_tpu.sync import correlate
    from trackmaker_tpu import sync as sync_mod
    pcfg = cfg or PhyConfig()
    pre = line_coding.preamble_waveform(pcfg)
    corr = sync_mod.normalized_xcorr(x, pre, correlate.preamble_energy(pre))
    return {"preamble corr": np.asarray(corr)}


def render_dashboard(source, out_html, title: str = "capture",
                     debug: dict[str, np.ndarray] | None = None,
                     ) -> pathlib.Path:
    """Write the interactive dashboard for a capture (file path, JSON
    dump, or ``(samples, sample_rate)``) to ``out_html``."""
    samples, sr = _load(source)
    samples = np.asarray(samples, np.float32)

    wave, stride = _envelope(samples, _MAX_WAVE)
    spec_db, hz_per = _spectrum_db(samples, sr)
    f, tt, sdb = spectrogram(samples, sr)
    if sdb.size:
        sdb = _pool_max(sdb, 1, _MAX_SGRAM_T)           # [F, Tb]
        lo, hi = float(sdb.min()), float(sdb.max())
        sg_u8 = np.clip((sdb - lo) / max(hi - lo, 1e-9) * 255.0,
                        0, 255).astype(np.uint8)
        surf = _pool_max(_pool_max(sdb, 0, _MAX_SURF), 1, _MAX_SURF)
    else:
        lo, hi = -1.0, 0.0
        sg_u8 = np.zeros((1, 1), np.uint8)
        surf = np.zeros((2, 2), np.float32)

    dbg = []
    for name, arr in (debug or {}).items():
        arr = np.asarray(arr, np.float32)
        env, dstride = _envelope(arr, _MAX_WAVE)
        dbg.append({"name": name, "b64": _b64_f32(env),
                    "stride": dstride, "n": int(len(arr))})

    payload = {
        "title": title,
        "sr": sr,
        "n": int(len(samples)),
        "wave": _b64_f32(wave),
        "waveStride": stride,
        "spec": _b64_f32(spec_db),
        "hzPer": hz_per,
        "sgram": _b64_u8(sg_u8),
        "sgF": int(sg_u8.shape[0]),
        "sgT": int(sg_u8.shape[1]),
        "sgLo": lo,
        "sgHi": hi,
        "sgFMax": sr / 2.0,
        "sgDur": len(samples) / sr if len(samples) else 0.0,
        "surf": _b64_f32(surf.astype(np.float32)),
        "surfF": int(surf.shape[0]),
        "surfT": int(surf.shape[1]),
        "stats": _stats_rows(samples),
        "debug": dbg,
    }

    doc = (_TEMPLATE
           .replace("__TITLE__", html_mod.escape(title))
           .replace("__PAYLOAD__", json.dumps(payload)))
    out = pathlib.Path(out_html)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(doc)
    return out


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__ — trackmaker-tpu</title>
<style>
 body{background:#14161a;color:#d8dce2;font:13px/1.4 system-ui,sans-serif;
      margin:0;padding:14px}
 h1{font-size:16px;margin:2px 0 10px} h2{font-size:13px;margin:12px 0 4px;
      color:#9aa3af;font-weight:600}
 .hint{color:#667086;font-size:11px;margin-left:8px;font-weight:400}
 canvas{display:block;background:#1b1e24;border:1px solid #2a2e36;
      border-radius:4px;width:100%}
 #readout{position:fixed;pointer-events:none;background:#262b33;
      border:1px solid #3a4150;padding:3px 7px;border-radius:3px;
      font-size:11px;display:none;z-index:9}
 table{border-collapse:collapse;margin-top:4px}
 td{border:1px solid #2a2e36;padding:3px 10px;font-size:12px}
 td:first-child{color:#9aa3af}
 .legend span{margin-right:14px;font-size:11px}
</style></head><body>
<h1>__TITLE__ <span class="hint">wheel = zoom x &nbsp; drag = pan &nbsp;
 double-click = reset &nbsp; (3-D: drag = rotate, wheel = zoom)</span></h1>
<div id="readout"></div>
<h2>waveform</h2><canvas id="wav" height="170"></canvas>
<div id="dbgwrap"></div>
<h2>spectrogram <span class="hint">x-axis synced with waveform</span></h2>
<canvas id="sg" height="220"></canvas>
<h2>spectrum</h2><canvas id="sp" height="170"></canvas>
<h2>3-D time–frequency surface</h2><canvas id="s3d" height="340"></canvas>
<h2>statistics</h2><div id="stats"></div>
<script>
"use strict";
const D = __PAYLOAD__;
const f32 = b => new Float32Array(Uint8Array.from(atob(b),c=>c.charCodeAt(0)).buffer);
const u8  = b => Uint8Array.from(atob(b), c=>c.charCodeAt(0));
const wave = f32(D.wave), spec = f32(D.spec), sgram = u8(D.sgram),
      surf = f32(D.surf);
const dur = D.n / D.sr;
const readout = document.getElementById("readout");
function showReadout(ev, txt){ readout.style.display="block";
  readout.style.left=(ev.clientX+14)+"px"; readout.style.top=(ev.clientY+10)+"px";
  readout.textContent = txt; }
function hideReadout(){ readout.style.display="none"; }
// viridis-ish LUT
const LUT = (()=>{const s=[[68,1,84],[59,82,139],[33,145,140],[94,201,98],
  [253,231,37]], L=[];
  for(let i=0;i<256;i++){const p=i/255*(s.length-1),j=Math.min(s.length-2,
    Math.floor(p)),f=p-j;L.push([0,1,2].map(k=>s[j][k]+(s[j+1][k]-s[j][k])*f));}
  return L;})();

// shared x-view (fraction of capture) for the time-aligned panels
const xv = {a:0, b:1};
const linked = [];
function setupCanvas(c){ const r = c.getBoundingClientRect();
  c.width = Math.max(640, Math.floor(r.width * devicePixelRatio));
  c.height = Math.floor(c.height); return c.getContext("2d"); }

function axis(ctx, W, H){ ctx.strokeStyle="#2a2e36"; ctx.beginPath();
  for(let i=1;i<10;i++){const x=W*i/10; ctx.moveTo(x,0); ctx.lineTo(x,H);}
  ctx.stroke(); }

function lineChart(canvas, data, opts){
  // data: Float32Array of y values spanning [0,1] of the x-domain
  const ctx = setupCanvas(canvas); let W=canvas.width, H=canvas.height;
  const view = opts.view || {a:0,b:1};
  function draw(){
    W = canvas.width; H = canvas.height;
    ctx.fillStyle = "#1b1e24"; ctx.fillRect(0,0,W,H); axis(ctx,W,H);
    const n = data.length, i0 = Math.max(0, Math.floor(view.a*n)),
          i1 = Math.min(n, Math.ceil(view.b*n));
    let lo=Infinity, hi=-Infinity;
    for(let i=i0;i<i1;i++){const v=data[i]; if(v<lo)lo=v; if(v>hi)hi=v;}
    if(!(hi>lo)){lo-=1;hi+=1;} const pad=(hi-lo)*0.07; lo-=pad; hi+=pad;
    ctx.strokeStyle = opts.color||"#6fb3ff"; ctx.lineWidth=1; ctx.beginPath();
    const span = i1-i0;
    if(span > W*2){ // per-pixel min/max columns
      for(let px=0;px<W;px++){
        const a=i0+Math.floor(span*px/W), b=i0+Math.floor(span*(px+1)/W);
        let l=Infinity,h=-Infinity;
        for(let i=a;i<b;i++){const v=data[i]; if(v<l)l=v; if(v>h)h=v;}
        if(l>h)continue;
        const y0=H-(l-lo)/(hi-lo)*H, y1=H-(h-lo)/(hi-lo)*H;
        ctx.moveTo(px+0.5, y0); ctx.lineTo(px+0.5, y1-0.5);
      }
    } else {
      for(let i=i0;i<i1;i++){
        const x=(i-i0)/Math.max(span-1,1)*W, y=H-(data[i]-lo)/(hi-lo)*H;
        i===i0?ctx.moveTo(x,y):ctx.lineTo(x,y);
      }
    }
    ctx.stroke();
    ctx.fillStyle="#667086"; ctx.font="10px system-ui";
    ctx.fillText(opts.xlab(view.a), 4, H-4);
    ctx.fillText(opts.xlab(view.b), W-70, H-4);
    ctx.fillText(hi.toFixed(3), 4, 11); ctx.fillText(lo.toFixed(3), 4, H-16);
  }
  const rd = ()=> view.__linked ? redrawLinked(view) : draw();
  function zoom(ev){ ev.preventDefault();
    const fx = view.a + (view.b-view.a)*ev.offsetX*devicePixelRatio/W;
    const s = Math.exp(ev.deltaY*0.0015);
    view.a = Math.max(0, fx-(fx-view.a)*s);
    view.b = Math.min(1, fx+(view.b-fx)*s); rd(); }
  let dragX=null;
  canvas.addEventListener("wheel", zoom);
  canvas.addEventListener("mousedown", ev=>dragX=ev.offsetX);
  window.addEventListener("mouseup", ()=>dragX=null);
  canvas.addEventListener("mousemove", ev=>{
    if(dragX!==null){ const dx=(ev.offsetX-dragX)*devicePixelRatio/W*
        (view.b-view.a); dragX=ev.offsetX;
      const a=view.a-dx, b=view.b-dx;
      if(a>=0&&b<=1){view.a=a;view.b=b;} rd(); return; }
    const fx = view.a+(view.b-view.a)*ev.offsetX*devicePixelRatio/W;
    showReadout(ev, opts.hover(fx)); });
  canvas.addEventListener("mouseleave", hideReadout);
  canvas.addEventListener("dblclick", ()=>{view.a=0;view.b=1; rd();});
  draw();
  return {draw, view};
}
function redrawLinked(view){
  if(view!==undefined && view.__linked)
    linked.forEach(c=>{c.view.a=view.a; c.view.b=view.b;});
  linked.forEach(c=>c.draw());
}

// waveform + debug traces share the linked x-view
xv.__linked = true;
const wavChart = lineChart(document.getElementById("wav"), wave, {
  view: xv, color:"#6fb3ff",
  xlab: f=>(f*dur).toFixed(3)+" s",
  hover: f=>{const i=Math.floor(f*D.n);
    const j=Math.min(wave.length-1,Math.floor(f*wave.length));
    return (f*dur).toFixed(4)+" s  ·  sample "+i+"  ·  y≈"+
           wave[j].toFixed(4);}});
linked.push(wavChart);
const dbgwrap = document.getElementById("dbgwrap");
for(const d of D.debug){
  const h=document.createElement("h2");
  h.innerHTML = d.name + ' <span class="hint">decoder debug — synced</span>';
  const c=document.createElement("canvas"); c.height=120;
  dbgwrap.appendChild(h); dbgwrap.appendChild(c);
  const arr=f32(d.b64);
  const ch=lineChart(c, arr, {view:xv, color:"#ffb86f",
    xlab:f=>(f*dur).toFixed(3)+" s",
    hover:f=>{const j=Math.min(arr.length-1,Math.floor(f*arr.length));
      return d.name+" ≈ "+arr[j].toFixed(5)+"  @ "+(f*dur).toFixed(4)+" s";}});
  linked.push(ch);
}

// spectrum (independent x-view, in Hz)
lineChart(document.getElementById("sp"), spec, {
  color:"#7ee08a",
  xlab: f=>(f*spec.length*D.hzPer).toFixed(0)+" Hz",
  hover: f=>{const j=Math.min(spec.length-1,Math.floor(f*spec.length));
    return (f*spec.length*D.hzPer).toFixed(1)+" Hz  ·  "+
           spec[j].toFixed(1)+" dB";}}).draw();

// spectrogram heatmap, x synced
const sgCanvas = document.getElementById("sg");
const sgChart = (()=>{
  const ctx = setupCanvas(sgCanvas);
  const off = document.createElement("canvas");
  off.width=D.sgT; off.height=D.sgF;
  const octx = off.getContext("2d");
  const img = octx.createImageData(D.sgT, D.sgF);
  for(let y=0;y<D.sgF;y++)for(let x=0;x<D.sgT;x++){
    const v=sgram[(D.sgF-1-y)*D.sgT+x], c=LUT[v], k=4*(y*D.sgT+x);
    img.data[k]=c[0];img.data[k+1]=c[1];img.data[k+2]=c[2];img.data[k+3]=255;}
  octx.putImageData(img,0,0);
  function draw(){
    const W=sgCanvas.width,H=sgCanvas.height;
    ctx.imageSmoothingEnabled=false;
    ctx.clearRect(0,0,W,H);
    const sx=xv.a*D.sgT, sw=Math.max((xv.b-xv.a)*D.sgT,1e-6);
    ctx.drawImage(off, sx,0,sw,D.sgF, 0,0,W,H);
    ctx.fillStyle="#d8dce2"; ctx.font="10px system-ui";
    ctx.fillText((xv.a*dur).toFixed(3)+" s",4,H-4);
    ctx.fillText((xv.b*dur).toFixed(3)+" s",W-70,H-4);
    ctx.fillText((D.sgFMax/1000).toFixed(1)+" kHz",4,11);
  }
  sgCanvas.addEventListener("mousemove", ev=>{
    const W=sgCanvas.width,H=sgCanvas.height;
    const f=xv.a+(xv.b-xv.a)*ev.offsetX*devicePixelRatio/W;
    const fy=(1-ev.offsetY/sgCanvas.getBoundingClientRect().height)*D.sgFMax;
    const tx=Math.min(D.sgT-1,Math.floor(f*D.sgT)),
          ty=Math.min(D.sgF-1,Math.floor(fy/D.sgFMax*D.sgF));
    const db=D.sgLo+(D.sgHi-D.sgLo)*sgram[ty*D.sgT+tx]/255;
    showReadout(ev,(f*dur).toFixed(3)+" s · "+(fy/1000).toFixed(2)+
        " kHz · "+db.toFixed(1)+" dB");});
  sgCanvas.addEventListener("mouseleave", hideReadout);
  sgCanvas.addEventListener("wheel", ev=>{ ev.preventDefault();
    const W=sgCanvas.width;
    const fx=xv.a+(xv.b-xv.a)*ev.offsetX*devicePixelRatio/W;
    const s=Math.exp(ev.deltaY*0.0015);
    xv.a=Math.max(0,fx-(fx-xv.a)*s); xv.b=Math.min(1,fx+(xv.b-fx)*s);
    redrawLinked(xv);});
  sgCanvas.addEventListener("dblclick",()=>{xv.a=0;xv.b=1;redrawLinked(xv);});
  let dragX=null;
  sgCanvas.addEventListener("mousedown",ev=>dragX=ev.offsetX);
  sgCanvas.addEventListener("mousemove",ev=>{
    if(dragX===null)return;
    const W=sgCanvas.width,dx=(ev.offsetX-dragX)*devicePixelRatio/W*(xv.b-xv.a);
    dragX=ev.offsetX; const a=xv.a-dx,b=xv.b-dx;
    if(a>=0&&b<=1){xv.a=a;xv.b=b;} redrawLinked(xv);});
  window.addEventListener("mouseup",()=>dragX=null);
  return {draw, view:xv};
})();
linked.push(sgChart);
redrawLinked();

// 3-D surface: drag-rotate painter's algorithm
(()=>{
  const canvas=document.getElementById("s3d"), ctx=setupCanvas(canvas);
  const F=D.surfF, T=D.surfT;
  let lo=Infinity,hi=-Infinity;
  for(const v of surf){if(v<lo)lo=v;if(v>hi)hi=v;}
  if(!(hi>lo)){lo-=1;hi+=1;}
  let rx=-1.05, rz=0.6, zoomF=1.0;
  function draw(){
    const W=canvas.width,H=canvas.height;
    ctx.fillStyle="#1b1e24"; ctx.fillRect(0,0,W,H);
    const ca=Math.cos(rz),sa=Math.sin(rz),cb=Math.cos(rx),sb=Math.sin(rx);
    const S=Math.min(W,H)*0.62*zoomF;
    const quads=[];
    const P=(i,j)=>{
      const x=(j/(T-1)-0.5), y=(i/(F-1)-0.5),
            z=(surf[i*T+j]-lo)/(hi-lo)*0.55-0.27;
      const x1=x*ca-y*sa, y1=x*sa+y*ca;
      const y2=y1*cb-z*sb, z2=y1*sb+z*cb;
      return [W/2+x1*S, H/2+y2*S, z2,
              (surf[i*T+j]-lo)/(hi-lo)];};
    for(let i=0;i<F-1;i++)for(let j=0;j<T-1;j++){
      const p00=P(i,j),p01=P(i,j+1),p11=P(i+1,j+1),p10=P(i+1,j);
      quads.push({z:(p00[2]+p11[2])/2, v:(p00[3]+p11[3])/2,
                  pts:[p00,p01,p11,p10]});}
    quads.sort((a,b)=>a.z-b.z);
    for(const q of quads){
      const c=LUT[Math.min(255,Math.max(0,Math.round(q.v*255)))];
      ctx.fillStyle=`rgb(${c[0]|0},${c[1]|0},${c[2]|0})`;
      ctx.strokeStyle="rgba(20,22,26,0.35)";
      ctx.beginPath(); ctx.moveTo(q.pts[0][0],q.pts[0][1]);
      for(let k=1;k<4;k++)ctx.lineTo(q.pts[k][0],q.pts[k][1]);
      ctx.closePath(); ctx.fill(); ctx.stroke();}
    ctx.fillStyle="#667086"; ctx.font="10px system-ui";
    ctx.fillText("time →  /  freq ↑  /  height = dB ("+lo.toFixed(0)+
        ".."+hi.toFixed(0)+")",6,12);
  }
  let last=null;
  canvas.addEventListener("mousedown",ev=>last=[ev.clientX,ev.clientY]);
  window.addEventListener("mouseup",()=>last=null);
  canvas.addEventListener("mousemove",ev=>{if(!last)return;
    rz+=(ev.clientX-last[0])*0.008; rx+=(ev.clientY-last[1])*0.008;
    last=[ev.clientX,ev.clientY]; draw();});
  canvas.addEventListener("wheel",ev=>{ev.preventDefault();
    zoomF*=Math.exp(-ev.deltaY*0.001); draw();});
  draw();
})();

// stats table
document.getElementById("stats").innerHTML =
  "<table>"+D.stats.map(r=>"<tr><td>"+r[0]+"</td><td>"+r[1]+
  "</td></tr>").join("")+"</table>";
</script></body></html>
"""
